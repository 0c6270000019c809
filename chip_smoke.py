#!/usr/bin/env python3
"""Drive the cuvs_tpu_torch search path once on one CUDA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Builds the port's CUDA kernels from ``cuvs_tpu_torch/csrc`` (nvcc, sm_90a),
then runs the main search path at SIFT-1M shape (sift-128-euclidean: the
files under $CUVS_TPU_DATASET_DIR, else the seeded synthetic stand-in of the
same shape): 1,000,000 x 128 f32, 4096 queries, k = 10.

  1. exact ground truth through the fused exact kernel, cross-checked
     against the unfused path on 256 queries (bench/gt.py);
  2. approximate fused brute force in bfloat16;
  3. int8 fused brute force, alone and with 40 candidates + exact refine;
  4. IVF-Flat (1984 lists, bf16 storage) built by balanced k-means and
     searched with 64 probes through the fused scan kernel, with and
     without refine.

Launch counters are zeroed just before that run and read just after; every
kernel of the path must have launched. Then each kernel is held against its
plain PyTorch version on the inputs the path gave it: float pools to
rtol 1e-4 / atol 1e-3 (the same exact products summed in another order; ids
may differ only at near-ties, <= 0.1% of entries), int8 pools bit-identical.
Each approximate phase's recall may be at most 0.005 below the recall of the
same search run on the plain versions. Kernel and plain times are CUDA-event
times of one call at the path's shapes, after a warm-up call.

Prints the card's name and power limit, one line per phase, the launch
counts, one JSON line {"kernels": [...]}, and last
{"ok": true, "device": {...}}. Any failed check raises (exit code 1, no
final line). Without a CUDA device, or outside the repository, it exits 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N, NQ, K, CAND = 1_000_000, 4096, 10, 40
N_LISTS, N_PROBES = 1984, 64  # bench.py's n_lists rule at 1M rows
FLOAT_RTOL, FLOAT_ATOL, ID_MISMATCH = 1e-4, 1e-3, 1e-3
RECALL_SLACK = 0.005


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn):
    """CUDA-event time of one call of fn(), after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def kernels():
    from cuvs_tpu_torch.ops import bf_topk, ivf_scan

    # name, module, wrapper, plain version, source, TPU kernel it replaces
    return [
        ("bf_topk_exact", bf_topk, "bf_topk_exact", "bf_topk_exact_reference",
         "cuvs_tpu_torch/csrc/bf_topk.cu", "cuvs_tpu/ops/bf_topk_pallas.py:44"),
        ("bf_topk_approx", bf_topk, "bf_topk_approx", "bf_topk_approx_reference",
         "cuvs_tpu_torch/csrc/bf_topk.cu", "cuvs_tpu/ops/bf_topk_pallas.py:90"),
        ("ivf_scan", ivf_scan, "fused_ivf_scan", "fused_ivf_scan_reference",
         "cuvs_tpu_torch/csrc/ivf_scan.cu", "cuvs_tpu/ops/ivf_scan_pallas.py:56"),
    ]


@contextlib.contextmanager
def recording(calls):
    """Record each wrapper's arguments (last call per kernel and input dtype)."""
    saved = []
    for name, mod, wrapper, _, _, _ in kernels():
        fn = getattr(mod, wrapper)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls[(_name, str(args[0].dtype))] = (args, kw)
            return _fn(*args, **kw)

        saved.append((mod, wrapper, fn))
        setattr(mod, wrapper, rec)
    try:
        yield
    finally:
        for mod, wrapper, fn in saved:
            setattr(mod, wrapper, fn)


@contextlib.contextmanager
def plain_versions():
    """Route the wrappers to their plain PyTorch versions."""
    saved = []
    for _, mod, wrapper, plain, _, _ in kernels():
        saved.append((mod, wrapper, getattr(mod, wrapper)))
        setattr(mod, wrapper, getattr(mod, plain))
    try:
        yield
    finally:
        for mod, wrapper, fn in saved:
            setattr(mod, wrapper, fn)


def compare_pools(kernel_out, plain_out, exact_ints):
    import torch

    kv, ki = kernel_out
    rv, ri = plain_out
    check(kv.shape == rv.shape and ki.shape == ri.shape, "pool shapes differ")
    if exact_ints:
        check(torch.equal(kv, rv) and torch.equal(ki, ri), "int8 pool is not bit-identical")
        return 0.0
    fin = torch.isfinite(rv)
    check(torch.equal(fin, torch.isfinite(kv)), "pools differ in their empty entries")
    err = (kv[fin] - rv[fin]).abs()
    check(bool((err <= FLOAT_ATOL + FLOAT_RTOL * rv[fin].abs()).all()),
          f"pool values differ beyond tolerance (max abs err {float(err.max())})")
    mism = float((ki != ri).float().mean())
    check(mism <= ID_MISMATCH, f"pool ids differ at {mism:.2e} of entries")
    return float(err.max()) if err.numel() else 0.0


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cuvs_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(cuvs_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from cuvs_tpu_torch.bench import datasets
    from cuvs_tpu_torch.bench.gt import exact_ground_truth, id_recall
    from cuvs_tpu_torch.bench.measure import timed_qps
    from cuvs_tpu_torch.neighbors import brute_force, ivf_flat, refine
    from cuvs_tpu_torch.ops import _lib, bf_topk, ivf_scan

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.time()
    _lib.lib()
    print(f"# build: {time.time() - t0:.1f} s (nvcc, sm_90a) -> {_lib.library_path().name}")

    t0 = time.time()
    ds = datasets.load("sift-128-euclidean", max_rows=N)
    x = torch.from_numpy(ds.base).to(dev)
    q = torch.from_numpy(ds.queries[:NQ].astype("float32")).to(dev)
    n, dim = x.shape
    print(f"# dataset sift-128-euclidean{' (synthetic)' if ds.synthetic else ''}: "
          f"n={n} d={dim} nq={q.shape[0]} k={K} ({time.time() - t0:.1f} s)")

    results, calls = {}, {}
    for counter in (bf_topk.LAUNCHES, ivf_scan.LAUNCHES):
        for key in counter:
            counter[key] = 0
    with recording(calls):
        # 1. exact ground truth (fused exact kernel, unfused cross-check)
        t0 = time.time()
        bf = brute_force.build(x, metric=ds.metric)
        gti = exact_ground_truth(bf, q, K)
        print(f"# ground truth: fused exact kernel, cross-check on 256 queries passed "
              f"({time.time() - t0:.1f} s)")

        def phase(label, fn):
            d, i = fn(q)
            torch.cuda.synchronize()
            check(d.shape == (q.shape[0], K) and i.shape == (q.shape[0], K), f"{label}: shape")
            check(bool(torch.isfinite(d).all()), f"{label}: non-finite distances")
            rec = id_recall(i.cpu(), gti)
            qps = timed_qps(fn, q, reps=5, min_time_s=1.0, max_reps=32)
            print(f"# {label}: recall@10={rec:.4f} qps={qps:.0f}")
            results[label] = dict(fn=fn, recall=rec, qps=qps)

        # 2. approximate fused brute force, bf16
        phase("bf_fused_bf16", lambda qq: brute_force.search(
            bf, qq, K, compute_dtype=torch.bfloat16, recall_target=0.97, fused=True))
        # 3. int8 fused brute force, alone and + refine
        bf8 = brute_force.build(x, metric=ds.metric, storage_dtype=torch.int8)
        int8_kw = dict(recall_target=0.97, fused=True)
        phase("bf_int8_fused", lambda qq: brute_force.search(bf8, qq, K, **int8_kw))
        phase("bf_int8_fused_refine", lambda qq: refine.refine(
            x, qq, brute_force.search(bf8, qq, CAND, **int8_kw)[1], K, metric=ds.metric))
        # 4. IVF-Flat, fused cluster-major scan
        t0 = time.time()
        idx = ivf_flat.build(x, n_lists=N_LISTS, metric=ds.metric, seed=0,
                             storage_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        sizes = idx.lists.sizes.float()
        print(f"# ivf_flat build: {N_LISTS} lists, sizes min/mean/max "
              f"{int(sizes.min())}/{float(sizes.mean()):.0f}/{int(sizes.max())}, "
              f"window {idx.window} ({time.time() - t0:.1f} s)")
        sp = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="fused",
                                   compute_dtype=torch.bfloat16, recall_target=0.97)
        phase(f"ivf_fused_p{N_PROBES}", lambda qq: ivf_flat.search(idx, qq, K, sp))
        phase(f"ivf_fused_p{N_PROBES}_refine", lambda qq: refine.refine(
            x, qq, ivf_flat.search(idx, qq, CAND, sp)[1], K, metric=ds.metric))
    torch.cuda.synchronize()
    print(f"# peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    launches = {**bf_topk.LAUNCHES, **ivf_scan.LAUNCHES}
    print("# launches during the main path: " + json.dumps(launches))
    for name, *_ in kernels():
        check(launches[name] > 0, f"kernel {name} was not launched by the main path")

    # each approximate phase against the same search on the plain versions
    with plain_versions():
        for label, r in results.items():
            d, i = r["fn"](q)
            plain_rec = id_recall(i.cpu(), gti)
            print(f"# {label}: plain-version recall@10={plain_rec:.4f}")
            check(r["recall"] >= plain_rec - RECALL_SLACK,
                  f"{label}: kernel recall {r['recall']:.4f} < plain {plain_rec:.4f} - "
                  f"{RECALL_SLACK}")
    check(results["bf_int8_fused_refine"]["recall"] > 0.9, "int8 + refine recall too low")

    # each kernel against its plain version on the path's own inputs
    report = []
    for name, mod, wrapper, plain, source, replaces in kernels():
        variants = {}
        for (kname, dtype), (args, kw) in sorted(calls.items()):
            if kname != name:
                continue
            ms, out = cuda_ms(lambda: getattr(mod, wrapper)(*args, **kw))
            plain_ms, ref = cuda_ms(lambda: getattr(mod, plain)(*args, **kw))
            err = compare_pools(out, ref, exact_ints=dtype == "torch.int8")
            shape = "x".join(str(s) for s in out[0].shape)
            print(f"# {name} [{dtype}]: pool {shape} matches plain (max abs err {err:.3g}); "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            variants[dtype.replace("torch.", "")] = dict(ms=ms, plain_ms=plain_ms,
                                                         max_abs_err=err)
        check(variants, f"no recorded call of {name}")
        # headline: the bf16 call where the path makes one (int8 is in variants)
        head = variants.get("bfloat16") or next(iter(variants.values()))
        report.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                           launches=launches[name],
                           max_abs_err=max(v["max_abs_err"] for v in variants.values()),
                           ms=head["ms"], plain_ms=head["plain_ms"], variants=variants))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
