"""Time the brute-force kernels against an earlier build of them, on one card.

    python -m cuvs_tpu_torch.bench.bf_topk_compare [--parent-csrc DIR] [--reps 3]

At chip_smoke.py's shapes (sift-128-euclidean, 1,000,000 x 128, 4096
queries, k = 10) it times, per variant (exact f32 at tile 2048; approx bf16
and int8 at tile 32768), this tree's kernel, the kernel built from the
sources in DIR (an earlier ``cuvs_tpu_torch/csrc``, same C interface) and the
plain PyTorch version, in turns: plain, new, earlier, earlier, new, plain.
Each time is the CUDA-event mean of ``reps`` calls after a warm-up. Beside
them: the bound and the cuBLAS product of the same operands
(``roofline.py``), and the per-batch split of the bf16 and int8 fused
searches into their host-side steps and the kernel. ``--ptxas`` adds each
kernel's registers and spills as ``nvcc -Xptxas -v`` reports them. Prints one
JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from cuvs_tpu_torch.bench import datasets, roofline
from cuvs_tpu_torch.distance.pairwise import row_norms
from cuvs_tpu_torch.neighbors import brute_force
from cuvs_tpu_torch.ops import _lib, bf_topk
from cuvs_tpu_torch.selection.select_k import topk

N, NQ, K = 1_000_000, 4096, 10


def timed(fn, reps: int) -> float:
    """CUDA-event mean ms of reps calls of fn(), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_earlier(csrc: Path, sources=("bf_topk.cu",),
                  entries=("cuvs_bf_topk_exact", "cuvs_bf_topk_approx")) -> ctypes.CDLL:
    """Compile ``sources`` of an earlier csrc (with its headers) into a
    library of its own, one nvcc per source at once, and bind its C
    ``entries``."""
    out = csrc / "_build" / f"libearlier_{'_'.join(Path(s).stem for s in sources)}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    objs = [str(out.parent / (Path(s).stem + ".o")) for s in sources]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda so: subprocess.run(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(csrc), "-c", "-o", so[1],
             str(csrc / so[0])], check=True), zip(sources, objs)))
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(out), *objs], check=True)
    so = ctypes.CDLL(str(out))
    for name in entries:
        fn = getattr(so, name)
        fn.argtypes = _lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return so


def ptxas_report(source: str = "bf_topk.cu") -> dict:
    """{kernel: {"registers": n, "stack": bytes, "spill_stores": bytes}} of one
    csrc source."""
    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_lib.CSRC),
                              "-c", "-o", os.path.join(tmp, "k.o"), str(_lib.CSRC / source)],
                             capture_output=True, text=True, check=True).stderr
    filt = Path(_lib._nvcc()).with_name("cu++filt")
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            if filt.exists():  # "void ns::f<T, (int)4>(args)" -> "ns::f<T, (int)4>"
                name = subprocess.run([str(filt), name], capture_output=True,
                                      text=True).stdout.strip()
                name = name.removeprefix("void ")
                name = name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                                      line)):
            out[name]["stack"] = int(m.group(1))
            out[name]["spill_stores"] = int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


@contextlib.contextmanager
def library(so):
    """Route the wrappers' launches to another build of the kernels."""
    saved = _lib.lib
    _lib.lib = lambda: so
    try:
        yield
    finally:
        _lib.lib = saved


def variants(x: torch.Tensor, q: torch.Tensor):
    """(name, wrapper, plain version, args) at the main path's shapes."""
    xn = row_norms(x)
    out = [("exact f32", bf_topk.bf_topk_exact, bf_topk.bf_topk_exact_reference,
            (q, x, row_norms(q), xn, K, 2048, False))]
    tile = 32768
    n_tiles = -(-x.shape[0] // tile)
    xb = x.to(torch.bfloat16)
    out.append(("approx bf16", bf_topk.bf_topk_approx, bf_topk.bf_topk_approx_reference,
                (q.to(torch.bfloat16), xb, bf_topk._penalty(xb, xn, n_tiles, tile, False, False),
                 tile, False)))
    scale = x.abs().max() / 127.0
    x8 = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    q8 = torch.clamp(torch.round(q / scale), -127, 127).to(torch.int8)
    key_pack = 4 * x.shape[1] * 16129 * 256 < 2 ** 31
    out.append(("approx int8", bf_topk.bf_topk_approx, bf_topk.bf_topk_approx_reference,
                (q8, x8, bf_topk._penalty(x8, None, n_tiles, tile, False, key_pack), tile,
                 key_pack)))
    return out


def search_split(x: torch.Tensor, q: torch.Tensor, reps: int) -> dict:
    """ms per 4096-query batch of the bf16 and int8 fused searches over
    indexes of x as given, and of their steps: the dataset's cast to the
    compute dtype, the penalty, the kernel, and the pool merge (selection +
    id decode)."""
    out = {}
    tile = 32768
    n_tiles = -(-x.shape[0] // tile)
    bf = brute_force.build(x)
    bf8 = brute_force.build(x, storage_dtype=torch.int8)
    for name, index, dtype in (("bf16", bf, torch.bfloat16), ("int8", bf8, torch.int8)):
        dd = index.dataset if dtype == torch.int8 else index.dataset.to(dtype)
        qq = (torch.clamp(torch.round(q / index.q_scale), -127, 127).to(torch.int8)
              if dtype == torch.int8 else q.to(dtype))
        key_pack = dtype == torch.int8
        pen = bf_topk._penalty(dd, index.norms, n_tiles, tile, False, key_pack)
        pool = bf_topk.bf_topk_approx(qq, dd, pen, tile, key_pack)

        def merge():
            pv = pool[0].permute(1, 0, 2).reshape(q.shape[0], -1)
            pi = pool[1].permute(1, 0, 2).reshape(q.shape[0], -1)
            tv, tl = topk(pv, K, True)
            return tv, torch.gather(pi, 1, tl)

        out[name] = {
            "search_ms": timed(lambda: brute_force.search(
                index, q, K, compute_dtype=torch.bfloat16, recall_target=0.97, fused=True), reps),
            "cast_ms": 0.0 if dtype == torch.int8 else timed(lambda: index.dataset.to(dtype), reps),
            "penalty_ms": timed(lambda: bf_topk._penalty(dd, index.norms, n_tiles, tile, False,
                                                         key_pack), reps),
            "kernel_ms": timed(lambda: bf_topk.bf_topk_approx(qq, dd, pen, tile, key_pack), reps),
            "merge_ms": timed(merge, reps),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="an earlier cuvs_tpu_torch/csrc to time against")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true", help="report registers and spills")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/bf_topk_compare.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf_topk_compare: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    t0 = time.time()
    _lib.lib()
    earlier = build_earlier(args.parent_csrc) if args.parent_csrc else None
    print(f"# builds: {time.time() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    ds = datasets.load("sift-128-euclidean", max_rows=N)
    x_raw = torch.from_numpy(ds.base).to(dev)  # as chip_smoke.py indexes it
    x = x_raw.float()
    q = torch.from_numpy(ds.queries[:NQ].astype("float32")).to(dev)
    report = {"card": card, "reps": args.reps, "variants": {}}
    if args.ptxas:
        report["ptxas"] = ptxas_report()
        for name, use in report["ptxas"].items():
            print(f"# ptxas {name}: {use}")
    for name, wrapper, plain, call in variants(x, q):
        new_fn = lambda: wrapper(*call)  # noqa: E731
        plain_fn = lambda: plain(*call)  # noqa: E731

        def earlier_fn():
            with library(earlier):
                return wrapper(*call)

        times = {"plain": [], "new": [], "earlier": []}
        order = ["plain", "new", "earlier", "earlier", "new", "plain"]
        fns = {"plain": plain_fn, "new": new_fn, "earlier": earlier_fn}
        for who in order:
            if who == "earlier" and earlier is None:
                continue
            times[who].append(timed(fns[who], args.reps))
        out = new_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        fin = torch.isfinite(ref[0])
        row = {f"{who}_ms": t for who, t in times.items() if t}
        row.update(roofline.kernel_bound(wrapper.__name__, call, {}, out))
        row["share"] = row["bound_ms"] / (sum(times["new"]) / len(times["new"]))
        row["product_ms"] = roofline.product_ms(call[0], call[1])
        row["max_abs_err"] = float((out[0][fin] - ref[0][fin]).abs().max())
        row["ids_differ"] = float((out[1] != ref[1]).float().mean())
        report["variants"][name] = row
        print(f"# {name}: {json.dumps(row)}")
    report["search_split"] = search_split(x_raw, q, args.reps)
    print(f"# search split: {json.dumps(report['search_split'])}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
