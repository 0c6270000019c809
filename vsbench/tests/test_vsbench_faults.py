"""The comparison refuses the control and each fault the timed path can
have, driven through the rest of a run on the CPU."""

import pytest
import torch

from vsbench import control, harness, spec
from vsbench.tests.conftest import CELLS, SHRINK


def half_batch(algo):
    """Half of each batch answered, the rest given the first half's answers;
    a batch of one query: every second request given the one before's."""
    def searcher(index, base, cfg):
        fn = algo.searcher(index, base, cfg)
        last = []

        def search(q):
            if q.shape[0] == 1:
                if last and len(last) % 2:
                    last.append(last[-1])
                else:
                    last.append(fn(q))
                return last[-1]
            h = q.shape[0] // 2
            reps = -(-q.shape[0] // h)
            return tuple(t.repeat(reps, 1)[:q.shape[0]] for t in fn(q[:h]))
        return search
    return control.wrap(algo, searcher=searcher)


def altered_answer(algo):
    """One id of one answer altered where it is produced."""
    def searcher(index, base, cfg):
        fn = algo.searcher(index, base, cfg)

        def search(q):
            d, i, *rest = fn(q)
            i = i.clone()
            i[-1, 0] = (i[-1, 0] + 1) % base.shape[0]
            return (d, i, *rest)
        return search
    return control.wrap(algo, searcher=searcher)


def unchanged_codes(algo):
    """The build leaves its codes as they started: all zero."""
    def state(index):
        st = algo.state(index)
        return dict(st, codes=torch.zeros_like(st["codes"]))
    return control.wrap(algo, state=state)


def altered_code(algo):
    """One code of one row altered where it is produced."""
    def state(index):
        st = algo.state(index)
        codes = st["codes"].clone()
        codes[5, 3] = (codes[5, 3] + 128) % 256
        return dict(st, codes=codes)
    return control.wrap(algo, state=state)


SEARCH_FAULTS = [half_batch, altered_answer]
BUILD_FAULTS = [unchanged_codes, altered_code, control.untrained]


@pytest.mark.parametrize("fault", SEARCH_FAULTS)
@pytest.mark.parametrize("cell", CELLS[:3])
def test_search_faults_are_not_correct(cell, fault):
    r = harness.run_cell(cell, 4242, 0.3, False, "cpu", overrides=SHRINK, fault=fault)
    assert r["correct"] is False and r["failed"] >= 1


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_candidates_from_part_of_the_pool_are_not_correct(cell):
    r = harness.run_cell(cell, 4243, 0.3, False, "cpu", overrides=SHRINK, fault=control.half_probes)
    miss = r["checks"]["cand_miss"]
    assert r["correct"] is False and miss["value"] > miss["limit"]


@pytest.mark.parametrize("fault", BUILD_FAULTS)
def test_build_faults_are_not_correct(fault):
    r = harness.run_cell(CELLS[3], 4242, 0.3, False, "cpu", overrides=SHRINK, fault=fault)
    assert r["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_and_program_is(cell):
    """The reference with TF32 products, in the program's place, fails a
    number; the program at the same seed passes each (TF32 is emulated by
    rounding the operands: the CPU has no TF32)."""
    from vsbench import check

    cfg = spec.config(spec.benchmark(), spec.cell(spec.benchmark(), cell)["config"],
                      overrides=SHRINK)
    numbers = check.build_numbers if cell.endswith("build") else check.search_numbers
    for side, raw in control.readings(cell, 77, "cpu", 8, SHRINK):
        raw = dict({"recall_at_10": 1.0, "center_gain": 1.0, "book_gain": 1.0}, **raw)
        passed = all(n.passed for n in numbers(raw, spec.limits(cfg, cell)).values())
        assert passed == (side == "program"), (side, raw)


def test_the_query_major_scan_with_a_coarser_table_is_not_correct():
    """In the single-query cell the scan's table is float32: the program with
    a bf16 table, its own lower-precision path, fails ``pq_gap``."""
    from vsbench import check

    cell = CELLS[2]
    cfg = spec.config(spec.benchmark(), spec.cell(spec.benchmark(), cell)["config"],
                      overrides=SHRINK)
    got = dict(control.readings(cell, 78, "cpu", 8, SHRINK, ("program", "lut_bfloat16")))
    limits = spec.limits(cfg, cell)
    assert check.search_numbers(got["program"], limits)["pq_gap"].passed
    assert not check.search_numbers(got["lut_bfloat16"], limits)["pq_gap"].passed
