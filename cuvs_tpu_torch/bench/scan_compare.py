"""Time the IVF scan kernels against an earlier build of them, on one card.

    python -m cuvs_tpu_torch.bench.scan_compare [--parent-csrc DIR] [--reps 3] [--ptxas]
        [--searches SUBSTR,...]

At chip_smoke.py's shapes (sift-128-euclidean, 1,000,000 x 128, 4096 queries, k
= 10; IVF-Flat with 1984 lists in bf16 and 64 probes; IVF-PQ with 1024 lists,
pq_dim 64, 8 bits and 50 probes; IVF-RaBitQ with 1024 lists, 3 bits and 50
probes), plus IVF-Flat as the bench CLI builds it (1024 lists, default storage:
f32 rows) searched at 10 and 100 probes, and the bf16 index searched with f32
queries, it builds the indexes, records the scan wrappers' calls of one search
each, and times per variant (ivf_scan bfloat16, bf16rows-f32q, f32-p10,
f32-p100; pq_scan pq-bf16, pq-int8lut, rabitq-3bit) this tree's kernel, the
kernel built from the sources in DIR (an earlier ``cuvs_tpu_torch/csrc``, same
C interface) and the plain PyTorch version, in turns: plain, new, earlier,
earlier, new, plain. The deep bins (cap = ceil(k / 32) > 2) have variants of
their own: the same IVF-Flat (f32 at 100 probes, bf16, bf16 rows with f32
queries), IVF-PQ (bf16 and int8 tables) and IVF-RaBitQ searches at k = 100
(``-k100``: cap 4), the IVF-Flat f32 and bf16 ones at k = 258 (``-k258``: cap
9, depth classes 16 and 8), and the search of CAGRA's IVF-PQ graph build (1000
lists, the default IVF-PQ parameters, 50 probes, the first 4096 base rows as
queries) at k = 194 (``-k194``: cap 7, the 96 -> 64 build of chip_smoke.py) and
258 (``-k258``: cap 9, cuVS's default 128 -> 64). The code widths other than
PQ 8-bit and RaBitQ 3-bit have variants of their own (``-<b>bit``): IVF-PQ at
pq_bits 4, 5 and 6 in the same shape (bf16 and int8 tables), IVF-RaBitQ at 1,
2, 4, 5 and 8 bits in phase 7's, each at k = 10 and 100, and the RaBitQ ones as
the bench CLI searches them too (``-cli``: 10,000 queries, 10 probes). Each
time is the CUDA-event mean of ``reps`` calls after a warm-up. Beside them: the bound
(``roofline.py``), the kernel's share of it, how far its pool is from the plain
version's, and for the quantized scan the shared-memory ceiling of its table
lookups (``smem_ms``: every lookup's table bytes, S per valid (slot, row) pair,
read once at 128 bytes per clock per SM at the card's maximum SM clock, with no
bank conflict), whether the pool is bit-identical to DIR's build's
(``same_as_earlier``), and for ``ivf_scan`` the kernel the call ran
(``kernel``: registers, local bytes, depth class, slots a block, column parts;
for ``pq_scan`` registers, local bytes, slots, blocks an SM holds, depth class
and family). ``--ptxas`` adds every kernel's registers, stack and spills. ``--searches``
keeps the searches whose names hold one of the substrings, and builds only
their indexes. Then the per-batch split of each search into coarse search, pair
grouping and windows (with the quantized searches' rotated operands, codebook
and per-probe cluster terms), the kernel, and the pool merge, each the sum of
CUDA-event times of its calls inside one search, meaned over ``reps`` searches,
beside the search's own time. Prints one JSON object and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from cuvs_tpu_torch.bench import datasets, roofline
from cuvs_tpu_torch.bench.bf_topk_compare import build_earlier, library, ptxas_report, timed
from cuvs_tpu_torch.neighbors import ivf_common, ivf_flat, ivf_pq, ivf_rabitq
from cuvs_tpu_torch.neighbors import ivf_scan as nb_scan
from cuvs_tpu_torch.ops import _lib
from cuvs_tpu_torch.ops import ivf_scan as ops_scan

N, NQ, K = 1_000_000, 4096, 10
N_LISTS, N_PROBES = 1984, 64  # chip_smoke.py's IVF-Flat
CLI_LISTS, CLI_PROBES = 1024, (10, 100)  # the bench CLI's f32 IVF-Flat (configs/ivf_flat.yaml)
Q_LISTS, Q_PROBES = 1024, 50  # chip_smoke.py's IVF-PQ and IVF-RaBitQ
DEEP_K = 100  # the k of the deep-bin variants of those searches (cap 4)
# a deeper IVF-Flat k (cap 9): depth class 16 over the CLI index's 9-slice
# window, 8 over the bf16 index's 5 (a bin takes one score a slice)
FLAT_WIDE_K = 258
# CAGRA's IVF-PQ graph build at 1M rows (knn_graph.build_knn_graph): sqrt(n)
# lists, 50 probes, (k + 1) * 2 candidates for 96 and 128 neighbours
CAGRA_LISTS, CAGRA_PROBES, CAGRA_KS = 1000, 50, (194, 258)
# the quantized scan's other code widths: IVF-PQ pq_bits (byte codes, book
# 2^b) and IVF-RaBitQ bits a dimension; the CLI's RaBitQ searches (its
# ivf_rabitq.yaml base grid) take the dataset's 10,000 queries at 10 probes
PQ_WIDTHS, RQ_WIDTHS, CLI_RQ_PROBES = (4, 5, 6), (1, 2, 4, 5, 8), 10
SMEM_BYTES_PER_CLOCK = 128  # per SM: 32 banks of 4 bytes

# split phase -> the functions whose calls it sums (module, attribute)
PHASES = {
    "coarse": [(ivf_common, "coarse_search")],
    "grouping": [(nb_scan, "group_pairs_tiled"), (nb_scan, "_tile_windows"),
                 (nb_scan, "_rotated_operands"), (nb_scan, "block_diag_codebook"),
                 (nb_scan, "_cluster_offsets")],
    "kernel": [(ops_scan, "fused_ivf_scan"), (ops_scan, "fused_pq_scan")],
    "merge": [(nb_scan, "_flat_pool"), (nb_scan, "_pool_with_offsets")],
}


def indexes(x: torch.Tensor, metric, only=None, q_cli=None) -> dict:
    """{search name: search(q)} over chip_smoke.py's three IVF indexes, the
    CLI's f32 IVF-Flat, CAGRA's IVF-PQ build index and the IVF-PQ and
    IVF-RaBitQ indexes at the other code widths (the ``-cli`` searches take
    ``q_cli``, the CLI's queries, whatever q). ``only``: substrings of the
    names to keep (None: every search); only their indexes are built."""
    builders = {
        "flat": lambda: ivf_flat.build(x, n_lists=N_LISTS, metric=metric, seed=0,
                                       storage_dtype=torch.bfloat16),
        "cli": lambda: ivf_flat.build(x, n_lists=CLI_LISTS, metric=metric, seed=0),
        "pq": lambda: ivf_pq.build(x, n_lists=Q_LISTS, pq_dim=64, pq_bits=8, metric=metric,
                                   seed=0),
        "rq": lambda: ivf_rabitq.build(x, n_lists=Q_LISTS, bits_per_dim=3, metric=metric,
                                       seed=0),
        "cg": lambda: ivf_pq.build(x, ivf_pq.IndexParams(
            n_lists=CAGRA_LISTS, metric=metric, seed=0,
            kmeans_trainset_fraction=100_000 / x.shape[0])),
        **{f"pq{b}": (lambda b=b: ivf_pq.build(x, n_lists=Q_LISTS, pq_dim=64, pq_bits=b,
                                               metric=metric, seed=0)) for b in PQ_WIDTHS},
        **{f"rq{b}": (lambda b=b: ivf_rabitq.build(x, n_lists=Q_LISTS, bits_per_dim=b,
                                                   metric=metric, seed=0)) for b in RQ_WIDTHS},
    }
    flat_sp = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="fused",
                                    compute_dtype=torch.bfloat16, recall_target=0.97)
    flat_f32q = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="fused")
    pq_sp = {lut: ivf_pq.SearchParams(n_probes=Q_PROBES, scan_algo="fused", lut_dtype=lut)
             for lut in (torch.bfloat16, torch.int8)}
    rq_sp = ivf_rabitq.SearchParams(n_probes=Q_PROBES, scan_algo="fused")
    base_q = x[:NQ]  # the graph build's first batch: base rows as queries
    # name -> (index, search(index, q))
    table = {
        "ivf_flat_bfloat16": ("flat", lambda ix, q: ivf_flat.search(ix, q, K, flat_sp)),
        "ivf_flat_bf16rows-f32q": ("flat", lambda ix, q: ivf_flat.search(ix, q, K, flat_f32q)),
        **{f"ivf_flat_f32-p{p}": ("cli", lambda ix, q, p=p: ivf_flat.search(ix, q, K, n_probes=p))
           for p in CLI_PROBES},
        "ivf_pq": ("pq", lambda ix, q: ivf_pq.search(ix, q, K, pq_sp[torch.bfloat16])),
        "ivf_pq_int8lut": ("pq", lambda ix, q: ivf_pq.search(ix, q, K, pq_sp[torch.int8])),
        "ivf_rabitq": ("rq", lambda ix, q: ivf_rabitq.search(ix, q, K, rq_sp)),
        # the deep bins: the same searches at k = 100, and the graph build's
        f"ivf_flat_f32-k{DEEP_K}": ("cli", lambda ix, q: ivf_flat.search(
            ix, q, DEEP_K, n_probes=CLI_PROBES[-1])),
        f"ivf_flat_bfloat16-k{DEEP_K}": ("flat", lambda ix, q: ivf_flat.search(
            ix, q, DEEP_K, flat_sp)),
        f"ivf_flat_bf16rows-f32q-k{DEEP_K}": ("flat", lambda ix, q: ivf_flat.search(
            ix, q, DEEP_K, flat_f32q)),
        f"ivf_flat_f32-k{FLAT_WIDE_K}": ("cli", lambda ix, q: ivf_flat.search(
            ix, q, FLAT_WIDE_K, n_probes=CLI_PROBES[-1])),
        f"ivf_flat_bfloat16-k{FLAT_WIDE_K}": ("flat", lambda ix, q: ivf_flat.search(
            ix, q, FLAT_WIDE_K, flat_sp)),
        f"ivf_pq-k{DEEP_K}": ("pq", lambda ix, q: ivf_pq.search(ix, q, DEEP_K,
                                                                pq_sp[torch.bfloat16])),
        f"ivf_pq_int8lut-k{DEEP_K}": ("pq", lambda ix, q: ivf_pq.search(ix, q, DEEP_K,
                                                                        pq_sp[torch.int8])),
        f"ivf_rabitq-k{DEEP_K}": ("rq", lambda ix, q: ivf_rabitq.search(ix, q, DEEP_K, rq_sp)),
        **{f"cagra_ivf_pq-k{k}": ("cg", lambda ix, q, k=k: ivf_pq.search(
            ix, base_q, k, n_probes=CAGRA_PROBES)) for k in CAGRA_KS},
    }
    for b in PQ_WIDTHS:
        for lut, name in ((torch.bfloat16, "ivf_pq"), (torch.int8, "ivf_pq_int8lut")):
            for k, tag in ((K, ""), (DEEP_K, f"-k{DEEP_K}")):
                table[f"{name}-{b}bit{tag}"] = (f"pq{b}", lambda ix, q, k=k, lut=lut: ivf_pq.search(
                    ix, q, k, pq_sp[lut]))
    for b in RQ_WIDTHS:
        for k, tag in ((K, ""), (DEEP_K, f"-k{DEEP_K}")):
            table[f"ivf_rabitq-{b}bit{tag}"] = (f"rq{b}", lambda ix, q, k=k: ivf_rabitq.search(
                ix, q, k, rq_sp))
        if q_cli is not None:
            table[f"ivf_rabitq-{b}bit-cli"] = (f"rq{b}", lambda ix, q: ivf_rabitq.search(
                ix, q_cli, K, n_probes=CLI_RQ_PROBES))
    keep = {name: v for name, v in table.items()
            if only is None or any(o in name for o in only)}
    built = {key: builders[key]() for key in dict.fromkeys(key for key, _ in keep.values())}
    return {name: (lambda q, ix=built[key], fn=fn: fn(ix, q)) for name, (key, fn) in keep.items()}


def scan_kernel_attributes(args, kw) -> dict:
    """The ivf_scan kernel that a recorded fused_ivf_scan call runs, without
    running it: registers, local (stack) bytes a thread, depth class, slots
    a block, column parts, threads a block."""
    data, queries, qidx, W, cap = args[0], args[2], args[3], kw["W"], kw.get("cap", 2)
    qdt = queries.dtype if data.dtype != torch.float32 else torch.float32  # as the wrapper widens
    out = (ctypes.c_int * 6)()
    _lib.check(_lib.lib().cuvs_ivf_scan_attributes(
        _lib.DTYPE_CODE[data.dtype], _lib.DTYPE_CODE[qdt], qidx.shape[1], data.shape[1], W, cap,
        out), "cuvs_ivf_scan_attributes")
    return dict(zip(("registers", "local_bytes", "depth", "slots", "parts", "threads"), out))


def pq_kernel_attributes(args, kw) -> dict:
    """The pq_scan kernel that a recorded fused_pq_scan call runs, without
    running it: registers, local (stack) bytes a thread, slots a block,
    blocks an SM holds, depth class, family (csrc/pq_scan.cuh Kind) and the
    source that holds it."""
    queries, cb_t, qidx = args[2], args[3], args[5]
    book, cap = kw.get("book", 256), kw.get("cap", 2)
    out = (ctypes.c_int * 6)()
    _lib.check(_lib.lib().cuvs_pq_scan_attributes(
        qidx.shape[1], queries.shape[1], cb_t.shape[1] // book, book, kw.get("bits", 8),
        kw["pq_len"], kw["W"], cap, int(kw.get("mode", "pq") == "rabitq"),
        int(bool(kw.get("int8_mode"))), out), "cuvs_pq_scan_attributes")
    attrs = dict(zip(("registers", "local_bytes", "slots", "blocks_per_sm", "depth", "family"),
                     out))
    # families 3 and 4 (csrc/pq_scan.cuh Kind) are the other compile-time widths
    attrs["source"] = ("pq_scan_widths.cu" if attrs["family"] >= 3 else
                       "pq_scan_deep.cu" if attrs["depth"] > 2 else "pq_scan.cu")
    return attrs


def pq_variant(kw) -> str:
    """The name of a fused_pq_scan call's variant: RaBitQ by its bits a
    code, IVF-PQ by its table type and, past 8 bits, its width (the book's
    log2: PQ codes sit in bytes whatever the width)."""
    if kw.get("mode", "pq") == "rabitq":
        return f"rabitq-{kw['bits']}bit"
    width = kw.get("book", 256).bit_length() - 1
    return (f"pq-{'int8lut' if kw.get('int8_mode') else 'bf16'}"
            + ("" if width == 8 else f"-{width}bit"))


@contextlib.contextmanager
def patched(wrap, phases=None):
    """Replace each function f of ``phases`` (PHASES) by wrap(phase, f) while
    inside."""
    saved = []
    for phase, fns in (PHASES if phases is None else phases).items():
        for mod, attr in fns:
            f = getattr(mod, attr)
            saved.append((mod, attr, f))
            setattr(mod, attr, wrap(phase, f))
    try:
        yield
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)


@contextlib.contextmanager
def phase_events(events: dict, phases=None):
    """Record CUDA events around every call of each function of ``phases``
    (PHASES) while inside: events[phase] gains (start, end) per call, read
    once the card has caught up."""
    def wrap(phase, f):
        def timed_call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = f(*args, **kw)
            end.record()
            events.setdefault(phase, []).append((start, end))
            return res
        return timed_call

    with patched(wrap, phases):
        yield


def record_calls(searches, q) -> dict:
    """{variant: (kernel name, wrapper, plain, args, kw)} from one search each."""
    calls = {}
    searching = [""]

    def wrap(phase, f):
        if phase != "kernel":
            return f
        name = "ivf_scan" if f.__name__ == "fused_ivf_scan" else "pq_scan"

        def rec(*args, **kw):
            if name == "ivf_scan":
                var = "ivf_scan " + searching[0].removeprefix("ivf_flat_")
            else:
                var = "pq_scan " + pq_variant(kw)
                if "-k" in searching[0]:
                    var += "-k" + searching[0].rsplit("-k", 1)[1]
                if searching[0].endswith("-cli"):
                    var += "-cli"
            calls[var] = (name, f, getattr(ops_scan, f.__name__ + "_reference"), args, kw)
            return f(*args, **kw)
        return rec

    with patched(wrap):
        for name, search in searches.items():
            searching[0] = name
            search(q)
    torch.cuda.synchronize()
    return calls


def smem_ms(kw, call) -> float:
    """Least time of a pq_scan call's table lookups through shared memory."""
    props = torch.cuda.get_device_properties(0)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits", "-i", "0"],
                               capture_output=True, text=True, check=True).stdout.strip())
    S = call[3].shape[1] // kw.get("book", 256)
    pairs = roofline._scan_pairs(call[5], call[7], call[8], kw["W"])
    n_bytes = S * pairs * (1 if kw.get("int8_mode") else 2)
    return n_bytes / (SMEM_BYTES_PER_CLOCK * props.multi_processor_count * mhz * 1e6) * 1e3


def search_split(searches, q, reps: int) -> dict:
    """ms per 4096-query batch of each search and of its phases."""
    out = {}
    for name, search in searches.items():
        events = {phase: [] for phase in PHASES}
        search(q)  # warm-up
        with phase_events(events):
            for _ in range(reps):
                search(q)
        torch.cuda.synchronize()
        row = {"search_ms": timed(lambda: search(q), reps)}
        for phase, ev in events.items():
            row[f"{phase}_ms"] = sum(s.elapsed_time(e) for s, e in ev) / reps
        row["rest_ms"] = row["search_ms"] - sum(row[f"{p}_ms"] for p in PHASES)
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="an earlier cuvs_tpu_torch/csrc to time against")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true", help="report registers and spills")
    ap.add_argument("--searches", default=None,
                    help="comma-separated substrings of the searches to run (default: all)")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/scan_compare.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_compare: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    t0 = time.time()
    _lib.lib()
    scan_sources = ("ivf_scan.cu", "ivf_scan_fma.cu", "ivf_scan_deep.cu", "ivf_scan_deep32.cu",
                    "pq_scan.cu", "pq_scan_deep.cu", "pq_scan_widths.cu")
    earlier = (build_earlier(args.parent_csrc,
                             [s for s in scan_sources if (args.parent_csrc / s).exists()],
                             ("cuvs_ivf_scan", "cuvs_pq_scan")) if args.parent_csrc else None)
    print(f"# builds: {time.time() - t0:.1f} s")
    report = {"card": card, "reps": args.reps, "variants": {}}
    if args.ptxas:
        with concurrent.futures.ThreadPoolExecutor(len(scan_sources)) as pool:  # nvcc at once
            report["ptxas"] = {k: v for rep in pool.map(ptxas_report, scan_sources)
                               for k, v in rep.items()}
        for name, use in report["ptxas"].items():
            print(f"# ptxas {name}: {use}")
    dev = torch.device("cuda", 0)
    ds = datasets.load("sift-128-euclidean", max_rows=N)
    x = torch.from_numpy(ds.base).float().to(dev)  # as chip_smoke.py indexes it
    q = torch.from_numpy(ds.queries[:NQ].astype("float32")).to(dev)
    q_cli = torch.from_numpy(ds.queries.astype("float32")).to(dev)
    t0 = time.time()
    searches = indexes(x, ds.metric, args.searches.split(",") if args.searches else None, q_cli)
    print(f"# index builds: {time.time() - t0:.1f} s")
    calls = record_calls(searches, q)
    for var, (name, wrapper, plain, call, kw) in sorted(calls.items()):
        def new_fn():
            return wrapper(*call, **kw)

        def plain_fn():
            return plain(*call, **kw)

        def earlier_fn():
            with library(earlier):
                return wrapper(*call, **kw)

        times = {"plain": [], "new": [], "earlier": []}
        fns = {"plain": plain_fn, "new": new_fn, "earlier": earlier_fn}
        for who in ["plain", "new", "earlier", "earlier", "new", "plain"]:
            if who == "earlier" and earlier is None:
                continue
            times[who].append(timed(fns[who], args.reps))
        out, ref = new_fn(), plain_fn()
        prev = earlier_fn() if earlier is not None else None
        torch.cuda.synchronize()
        fin = torch.isfinite(ref[0])
        row = {f"{who}_ms": t for who, t in times.items() if t}
        if prev is not None:  # the same pool, bit for bit, as the earlier build's
            row["same_as_earlier"] = bool(torch.equal(out[0], prev[0]) and
                                          torch.equal(out[1], prev[1]))
        row["kernel"] = (scan_kernel_attributes if name == "ivf_scan" else pq_kernel_attributes)(
            call, kw)
        row.update(roofline.kernel_bound(name, call, kw, out))
        row["share"] = row["bound_ms"] / (sum(times["new"]) / len(times["new"]))
        row["max_abs_err"] = float((out[0][fin] - ref[0][fin]).abs().max())
        row["ids_differ"] = float((out[1] != ref[1]).float().mean())
        if name == "pq_scan":
            row["smem_ms"] = smem_ms(kw, call)
        report["variants"][var] = row
        print(f"# {var}: {json.dumps(row)}")
    report["search_split"] = search_split(searches, q, args.reps)
    for name, row in report["search_split"].items():
        print(f"# split {name}: {json.dumps(row)}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
