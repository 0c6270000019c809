"""Time the IVF scan kernels against an earlier build of them, on one card.

    python -m cuvs_tpu_torch.bench.scan_compare [--parent-csrc DIR] [--reps 3] [--ptxas]

At chip_smoke.py's shapes (sift-128-euclidean, 1,000,000 x 128, 4096
queries, k = 10; IVF-Flat with 1984 lists in bf16 and 64 probes; IVF-PQ with
1024 lists, pq_dim 64, 8 bits and 50 probes; IVF-RaBitQ with 1024 lists,
3 bits and 50 probes), plus IVF-Flat as the bench CLI builds it (1024 lists,
default storage: f32 rows) searched at 10 and 100 probes, and the bf16 index
searched with f32 queries, it builds the indexes, records the scan wrappers'
calls of one search each, and times per variant (ivf_scan bfloat16,
bf16rows-f32q, f32-p10, f32-p100; pq_scan pq-bf16, pq-int8lut, rabitq) this
tree's kernel, the kernel built from the sources in DIR (an earlier
``cuvs_tpu_torch/csrc``, same C interface) and the plain PyTorch version, in
turns: plain, new, earlier, earlier, new, plain. Each time is the CUDA-event
mean of ``reps`` calls after a warm-up. Beside them: the bound (``roofline.py``), the kernel's share of
it, how far its pool is from the plain version's, and for the quantized scan
the shared-memory ceiling of its table lookups (``smem_ms``: every lookup's
table bytes, S per valid (slot, row) pair, read once at 128 bytes per clock
per SM at the card's maximum SM clock, with no bank conflict). ``--ptxas`` adds each
kernel's registers and spills. Then the per-batch split of each search into
coarse search, pair grouping and windows (with the quantized searches'
rotated operands, codebook and per-probe cluster terms), the kernel, and the
pool merge, each the sum of CUDA-event times of its calls inside one search,
meaned over ``reps`` searches, beside the search's own time. Prints one JSON
object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
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


def indexes(x: torch.Tensor, metric) -> dict:
    """{search name: search(q)} over chip_smoke.py's three IVF indexes."""
    flat = ivf_flat.build(x, n_lists=N_LISTS, metric=metric, seed=0,
                          storage_dtype=torch.bfloat16)
    flat_sp = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="fused",
                                    compute_dtype=torch.bfloat16, recall_target=0.97)
    flat_f32q = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="fused")
    cli = ivf_flat.build(x, n_lists=CLI_LISTS, metric=metric, seed=0)
    pq = ivf_pq.build(x, n_lists=Q_LISTS, pq_dim=64, pq_bits=8, metric=metric, seed=0)
    pq_sp = {lut: ivf_pq.SearchParams(n_probes=Q_PROBES, scan_algo="fused", lut_dtype=lut)
             for lut in (torch.bfloat16, torch.int8)}
    rq = ivf_rabitq.build(x, n_lists=Q_LISTS, bits_per_dim=3, metric=metric, seed=0)
    rq_sp = ivf_rabitq.SearchParams(n_probes=Q_PROBES, scan_algo="fused")
    return {
        "ivf_flat_bfloat16": lambda q: ivf_flat.search(flat, q, K, flat_sp),
        "ivf_flat_bf16rows-f32q": lambda q: ivf_flat.search(flat, q, K, flat_f32q),
        **{f"ivf_flat_f32-p{p}": (lambda q, p=p: ivf_flat.search(cli, q, K, n_probes=p))
           for p in CLI_PROBES},
        "ivf_pq": lambda q: ivf_pq.search(pq, q, K, pq_sp[torch.bfloat16]),
        "ivf_pq_int8lut": lambda q: ivf_pq.search(pq, q, K, pq_sp[torch.int8]),
        "ivf_rabitq": lambda q: ivf_rabitq.search(rq, q, K, rq_sp),
    }


@contextlib.contextmanager
def patched(wrap):
    """Replace each PHASES function f by wrap(phase, f) while inside."""
    saved = []
    for phase, fns in PHASES.items():
        for mod, attr in fns:
            f = getattr(mod, attr)
            saved.append((mod, attr, f))
            setattr(mod, attr, wrap(phase, f))
    try:
        yield
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)


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
                mode = kw.get("mode", "pq")
                lut = "int8lut" if kw.get("int8_mode") else "bf16"
                var = f"pq_scan {mode if mode == 'rabitq' else 'pq-' + lut}"
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

        def wrap(phase, f):
            def timed_call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = f(*args, **kw)
                end.record()
                events[phase].append((start, end))
                return res
            return timed_call

        search(q)  # warm-up
        with patched(wrap):
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
    scan_sources = ("ivf_scan.cu", "ivf_scan_fma.cu", "pq_scan.cu")
    earlier = (build_earlier(args.parent_csrc,
                             [s for s in scan_sources if (args.parent_csrc / s).exists()],
                             ("cuvs_ivf_scan", "cuvs_pq_scan")) if args.parent_csrc else None)
    print(f"# builds: {time.time() - t0:.1f} s")
    report = {"card": card, "reps": args.reps, "variants": {}}
    if args.ptxas:
        report["ptxas"] = {k: v for src in scan_sources for k, v in ptxas_report(src).items()}
        for name, use in report["ptxas"].items():
            print(f"# ptxas {name}: {use}")
    dev = torch.device("cuda", 0)
    ds = datasets.load("sift-128-euclidean", max_rows=N)
    x = torch.from_numpy(ds.base).float().to(dev)  # as chip_smoke.py indexes it
    q = torch.from_numpy(ds.queries[:NQ].astype("float32")).to(dev)
    t0 = time.time()
    searches = indexes(x, ds.metric)
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
        torch.cuda.synchronize()
        fin = torch.isfinite(ref[0])
        row = {f"{who}_ms": t for who, t in times.items() if t}
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
