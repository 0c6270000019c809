#!/usr/bin/env python3
"""Drive the cuvs_tpu_torch search path once on one CUDA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Builds the port's CUDA kernels from ``cuvs_tpu_torch/csrc`` (nvcc, sm_90a),
then runs the main search path at SIFT-1M shape (sift-128-euclidean: the
files under $CUVS_TPU_DATASET_DIR, else the seeded synthetic stand-in of the
same shape): 1,000,000 x 128 f32, 4096 queries, k = 10.

  1. exact ground truth through the fused exact kernel, cross-checked
     against the unfused path on 256 queries (bench/gt.py);
  2. exact fused brute force in float32 (the default
     ``brute_force.search(fused=True)``), timed, its recall against (1);
  3. approximate fused brute force in bfloat16;
  4. int8 fused brute force, alone and with 40 candidates + exact refine;
  5. IVF-Flat (1984 lists, bf16 storage) built by balanced k-means and
     searched with 64 probes through the fused scan kernel, with and
     without refine; then the scan's deep bins (k = 100, cap 4), each search
     recorded as a variant of its own and its first 10 ids' recall at most
     0.005 below a k = 10 search of the same index and parameters: the
     bf16 index with bf16 queries (tensor cores, ``bfloat16-k100``), with
     f32 queries (the fp32 tile, ``bfloat16-f32q-k100``), and an f32-row
     index as the bench CLI builds it (1024 lists, p100, ``float32-k100``),
     each with the registers and local bytes of the kernel it ran;
  6. IVF-PQ (1024 lists, pq_dim 64, 8 bits, per-subspace codebooks: the
     ``base`` group of cuvs_tpu/bench/configs/ivf_pq.yaml) searched with 50
     probes through the fused quantized-code scan kernel, bf16 table alone
     and + refine from 40 candidates, int8 table + refine; then one search
     at k = 100 (bf16 table: the kernel's deep bins, cap 4, recorded as the
     variant ``pq-bf16-k100``), its first 10 ids' recall at most 0.005 below
     the k = 10 search's; then the same IVF-PQ at pq_bits 4 and 5 (byte codes
     with a book of 16 and 32: the kernel's other widths, variants
     ``pq-bf16-4bit`` and ``pq-bf16-5bit``), each searched at 50 probes with
     the bf16 table, the 4-bit one also with the int8 table
     (``pq-int8lut-4bit``) and at k = 100 (``pq-bf16-4bit-k100``: depth
     class 4), their recall printed beside the 8-bit index's, each kernel
     with the registers and local bytes of the instantiation it ran (none
     may spill);
  7. IVF-RaBitQ (1024 lists, 3 bits per dimension: ivf_rabitq.yaml ``base``;
     128 x 3 bits = 12 words, so codes straddle words) with 50 probes
     through the same kernel, alone and + refine;
  8. the phase-5 index through the unfused cluster-major scan (its recall
     may be at most 0.005 below phase 5's: its per-list selection is exact),
     then with a metric UDF (squared L2 by broadcasting, [.., d] blocks)
     under ``auto``: the same recall within 0.005, and at most 4 GiB of
     device memory above what the indexes hold (unchunked by d, one block
     of tiles would be about 34 GB);
  9. IVF-Flat cosine (1984 lists), ``auto`` (which routes cosine to the
     cluster-major scan), 64 probes, against a cosine ground truth (recall
     at least 0.86);
 10. IVF-Flat built on the first 900,000 rows, then ``extend`` by the last
     100,000, fused scan (n_rows 1M; recall at most 0.01 below phase 5's);
 11. ``ivf_flat.build_streaming`` in host mode from 10 numpy slices of
     100,000 rows: an int8 index (the ivf_scan kernel's int8 variant), alone
     and + refine;
 12. IVF-PQ with per-cluster codebooks (1024 lists, pq_dim 64, 8 bits)
     through the unfused cluster-major scan, alone and + refine (each at
     most 0.01 below phase 6's);
 13. IVF-PQ built on 900,000 rows + ``extend`` by 100,000, fused bf16 table,
     alone and + refine;
 14. ``ivf_pq.build_streaming`` from 10 host slices, fused, alone and +
     refine; its serving layout must equal ``pack_codes_transposed`` of its
     unpacked codes;
 15. ``refine_host`` from the host numpy base on phase 14's candidates: equal
     to ``refine.refine`` on the card (ids except at ties, distances rtol
     1e-5);
 16. IVF-SQ (1024 lists: ivf_sq.yaml ``base``), 50 probes, alone and + refine
     (at most 0.01 below phase 6 + refine: the same lists and probes);
 17. ``serialize.save`` then ``load`` of the phase-6 IVF-PQ and phase-11
     IVF-Flat indexes in a temporary directory: searches bit-identical;
 18. CAGRA built as bench.py builds it (128 -> 64, ``auto``: the partitioned
     exact knn graph at 1M, bf16 operands), its seconds split into the knn
     graph and ``optimize`` (detour counts apart); every id of the graph in
     [0, n), no self edge, no repeat within a row; the knn graph's recall@128
     on 1024 sampled rows against their exact neighbours (unfused brute
     force, k = 129), beside the share of those neighbours that lie in one of
     the row's two clusters (the partition's bound) and the recall of a bf16
     search over all rows (the operands' bound);
 19. CAGRA search at itopk 64 and 128 (search_width 2, bf16, one chunk of
     4096): recall@10 and QPS, itopk 128 at most 0.005 below 64; the
     benchmark cell's beam search (10,000 queries, the 4096 repeated, in one
     chunk at itopk 128, width 1, f32: the ``cagra_beam`` kernels line's
     headline variant) timed, one kernel launch for its chunk, and one a
     chunk for the 4096 queries in chunks of 1000; then itopk 64
     + exact refine from 40 candidates (not below the unrefined), climbing
     bench.py's ladder (128, 192) until recall@10 >= 0.95, or failing; the
     first 256 queries searched on a CPU copy of the index with the same seeds
     must return >= 99% of the card's (query, rank) ids; and, as a control of
     the graph degree, phase 18's knn graph pruned to 32 and searched at
     itopk 64 (recall and QPS printed, no floor);
 20. CAGRA built through IVF-PQ + refine (96 -> 64, of cagra.yaml ``base``:
     the degree of phase 19's graph, so the two builds compare): one fused
     ``pq_scan`` launch and one ``pool_topk`` launch (fetch 194) per 4096-row
     batch of the self-search (k = 194, cap 7: each recorded as its own
     variant), the graph's split per batch (the
     kernel against coarse search, grouping, the pool merge and refine,
     CUDA-event times summed over the build), the knn graph's recall@96 on
     phase 18's sampled rows,
     and its search at itopk 64 alone and + refine (at most 0.10 below phase
     19's itopk 64);
 21. unfused brute force for L1 and Linf over the 1M rows with 256 queries,
     held against ``torch.cdist`` + ``torch.topk`` (used only to check: ids
     equal except at ties, distances rtol 1e-5), ms per batch; and
     ``pairwise_distance`` for every metric on 512 x 512 x 128 on the card
     against the same call on the CPU (rtol 1e-5, atol 1e-5);
 22. phase 18's index packed (int8 child vectors beside each node's links,
     4 pieces of 16 neighbours at the default 2 GiB), searched at itopk 64
     and 128 and 128 + refine (recall at most 0.05 below phase 19's; QPS
     beside it), its median relative distance error against exact f32 ones
     (< 0.02, or the int8 rounding's own figure where that is larger), and
     packed again as one piece: the same ids, its QPS;
 23. phase 18's index VPQ-compressed (256 coarse centres, pq_dim 32 of 8
     bits), searched at itopk 128 alone and + refine from 40 (at least 0.85);
 24. the composite of two exact brute-force halves (the exact kernel twice a
     batch, its calls recorded apart): phase 2's ids but at ties; then
     CAGRA's logical merge of two 64 -> 32 halves of the first 300,000 rows;
 25. ``build_ace`` on the first 300,000 rows (4 partitions, overlap 2, 64 -> 32,
     the graph spilled to a memmap): a valid graph, its peak beside phase 18's,
     itopk 64 against those rows' exact top-10;
 26. ``build_iterative`` on the first 12,500 rows (32/64, 3 rounds): recall
     at least 0.50 against those rows' exact top-10; packed, its ids on the
     card and on a CPU copy (>= 99% equal); it and phase 23's index saved and
     loaded: searches bit-identical;
 27. Vamana at its defaults (R 32, L 64, alpha 1.2) on the first 100,000 rows
     (the script's time limit): ids in [0, n) or -1, no self edge, search at
     itopk 64 against those rows' exact top-10, DiskANN file round trip;
 28. HNSW from phase 18's index with levels linked on the card: level-1 links
     equal the host's but at ties, and the loaded file searches exactly as
     CAGRA over the same rows and graph;
 29. ScaNN (1024 lists, eta 2.0, lambda 1.5, pq_dim 64 of 8 bits, a bf16
     copy): its seconds split, its peak under 16 GiB above what is held, no
     SOAR label equal to its primary, the asset directory's round trip;
 30. ``mg.build(x, "brute_force", "sharded")`` on ``[cuda:0] * 4``: four shards
     of 250,000 rows, four exact-kernel launches a batch (recorded as their own
     variant), ids equal to phase 2's but at ties;
 31. ``mg.build(x, "ivf_flat")``, the distributed build (1984 lists, bf16, one
     set of centres trained over every row), 64 probes, fused scan: recall not
     below phase 5's less 0.005;
 32. ``mg.build_streaming(algo="ivf_pq")`` from 10 host slices over 4 shards
     (3, 3, 3 and 1 slices; 256 lists, pq_dim 64 x 8 bits a shard), 50 probes,
     k = 40, + refine: recall at least 0.80;
 33. ``mg.build(x, "ivf_flat", "replicated")`` over 4 replicas (one set of
     tensors on one card): 4 round-robin calls visit every replica and equal a
     direct search; the load balancer within 0.005 of its recall;
 34. ``mg.build(x[:300_000], "cagra")``: four shards of 75,000 rows built
     64 -> 32, each build timed, itopk 64: recall at least 0.80 against those
     rows' exact top-10;
 35. ``mg`` save and load of phases 31 and 32: the same header fields and
     bit-identical searches;
 36. k-means, 1024 clusters, 20 iterations, on the 1M rows: ``cluster.kmeans``
     (seconds of k-means++ and of Lloyd) and ``mg.kmeans_fit`` on 4 shards;
     the mg loop from the single-card fit's initial centres within 1e-3 of
     its inertia;
 37. ``tiered_index`` over IVF-Flat (phase 10's parameters, ANN tier on the
     first 900,000 rows, the last 100,000 in the hot tier; the exact kernel on
     those rows is recorded as its own variant, ``float32-tiered``): recall not below phase 10's less 0.005;
     save + load bit-identical; compacted, within 0.005 of phase 10's;
 38. ``io``: the rows written as .fbin and read back byte-identical, whole and
     in batches; ``offload.build`` of IVF-PQ (4 shards of 256 lists, pq_dim 64
     x 8 bits) from the file, its shards in pinned host memory, 50 probes: at
     most the largest shard + the partials + one shard's search workspace
     (measured with that shard alone on the card) + 16 MiB above what is held,
     so no second shard is there; recall at least 0.75; ``build_host_refined``
     (int8 IVF-Flat) from the
     file + ``search_refined`` (ratio 4, ``refine_host`` from the file): not
     below the unrefined search;
 39. ``dynamic_batching.wrap`` of phase 2's index (``max_batch_size`` 1024),
     python and native queues: 4096 one-query requests from 16 threads, every
     answer phase 2's but at ties, some batch holding two or more requests;
     requests/s and the latency percentiles printed;
 40. ball cover on the 1M rows (~1000 landmarks): ``knn_query`` of the 4096
     queries, two passes: recall@10 at least 0.999 against (1), distances the
     square roots of phase 2's within rtol 1e-3, QPS and the share of (query,
     cell) pairs pass 2 scans; ``eps_nn`` of 256 queries at eps = the median
     10th-neighbour distance: ``eps_neighbors``' adjacency but within 1e-4
     (relative) of eps; ``all_knn_query`` of the first SUB = 100,000 rows: an
     unfused exact self-search but at ties;
 41. ``eps_neighbors`` of 1024 queries over the 1M rows (a [1024, 1M] block);
 42. single linkage of the first SUB rows (15 neighbours, 16 clusters): its
     seconds split (knn graph, Borůvka rounds, repair rounds, dendrogram); the
     Borůvka forest's edge count and weight equal scipy's MST of the same
     symmetrized knn edges (rtol 1e-5); n - 1 merges, ascending heights;
 43. cross-component NN over phase 42's 16 labels: every edge joins two
     components, its distance a float64 recomputation's (rtol 1e-4), and no
     outside row nearer to the smallest component (``torch.cdist``);
 44. ``cluster.spectral.fit_predict`` of SUB rows, 8 clusters (its 8-column
     embedding through LOBPCG): each vector's eigen-residual below 1e-2 and
     its eigenvalue in [0, 2]; the dense embedding of the first 4096 rows
     against a float64 ``scipy.linalg.eigh`` on the host (its 10 smallest
     pairs), up to sign (atol 1e-4, columns whose eigenvalue is 1e-2 from its
     neighbours');
 45. PCA of the 1M rows to 32 components: the explained variance of
     ``numpy.linalg.eigh`` of the float64 covariance (rtol 1e-4), the
     components up to sign, the reconstruction error;
 46. silhouette of SUB rows under 64 k-means clusters and trustworthiness of
     phase 45's projection of 10,000 rows, the Gram matrices (4 kernels) of
     the 4096 queries against SUB rows and KDE (6 kernels) of 1024 queries
     over the 1M rows: each card against the CPU on a slice;
 47. sparse brute force on a TF-IDF-like CSR (SUB x 32,768, 64 non-zeros a
     row, Zipf columns; 1024 queries alike): inner product and cosine against
     scipy's product + argsort on the host, L1 over the first 20,000 rows
     against ``torch.cdist`` of the dense rows; QPS;
 48. the C ABI on the card, in subprocesses: the port's C library and
     ``csrc/capi_card_check.c``, which through ``cuvsTpuInit("gpu")``,
     ``cuvsTpuIndexBuild`` and ``cuvsTpuIndexSearch`` ({"fused": true}: the
     exact kernel) returns phase 2's ids but at ties; the untouched
     ``capi/c_test.c`` (its /tmp paths moved into a temporary directory),
     started on the host before phase 41 (two threads), walks the whole ABI
     and prints "C API smoke test PASSED". The kernels and the C library
     build in threads while the data is made.
 49. the bench CLI (``python -m cuvs_tpu_torch.bench``, ``__main__.main``
     in-process) on sift-128-euclidean at 1M rows, its 10,000 queries, k = 10:
     (a) ``--config ivf_rabitq --group base`` (1024 lists, 1/3/5/8 bits x
     probes 10/50/100: 12 rows), (b) ``--algo ivf_flat --algo ivf_pq`` at 1024
     lists with the default grids (4 + 6 rows), (c) brute force ``fused``,
     exact and f32 approximate (``recall_target`` 0.97: the f32 variant of
     the approximate kernel): the row counts the hooks leave, each CSV read
     back with the reference's seven columns, recall not falling (slack
     0.005) as n_probes grows within a build, the exact row at least 0.999,
     the 3-bit 50-probe RaBitQ row within 0.02 of phase 7's, and all five
     kernels of the IVF and brute-force searches launched by the CLI. The
     CLI's calls are recorded as variants of their own (``-cli``: the f32
     IVF-Flat scan, RaBitQ at 1, 3, 5 and 8 bits, ...), so each is held
     against its plain version with the others.
     Then one f32 approximate search of the 4096 queries (the kernels line's
     ``float32`` variant of ``bf_topk_approx``) and five IVF-PQ searches of
     the 10,000 queries, each under ``tracing.start_profiler_trace``: every
     trace names ``pq_scan_kernel``; the card's busy share of the traced and
     of the untraced wall time (medians of the five) is printed, with the
     median search's device time per kernel name.

Each of phases 40-48 prints its seconds and its device-memory peak above what
is held, beside the card's name and power limit; they launch none of the six
kernels in this process (checked), phase 48's driver launches the exact one in
its own.

Phases 30-39 are held against the plain versions as soon as they ran (their
indexes are freed before the next phase); their kernel calls are recorded
under variants of their own, so phases 1-29's recorded calls stay the
headline ones.

Launch counters are zeroed just before that run and read just after; every
kernel of the path must have launched. Each variant's line carries its own
count of wrapper calls in that run (each one launch on the card). Then each kernel is held against its
plain PyTorch version on the inputs the path gave it, once per variant
(row dtype, or mode and table type, RaBitQ's bits; the pool merge's offsets
and fetch; the beam search's types, itopk, width and degree): float pools to
rtol 1e-4 / atol 1e-3
(the same exact products summed in another order; ids may differ only at
near-ties, <= 0.1% of entries), int8 pools bit-identical, pools of the int8
lookup table within that tolerance except where an entry's lut/scale sits on
a rounding boundary (<= 0.1% of entries), the pool merge's selection bit for
bit (values and pool columns), the beam search's final lists equal on at
least 99% of their ids (a near-tie summed in another order steers a beam
elsewhere), the distances to that tolerance where the ids agree, the walk's
steps, parents and scored children summed over the queries within 1% of
the loop's. Each approximate phase's recall may be at most 0.005 below the
recall of the same search run on the plain versions, and each refined
phase's recall may not be below its unrefined phase's (the CAGRA, Vamana
and HNSW searches are held to the loop through the beam kernel's recorded
calls, not rerun). Kernel and plain times are CUDA-event times of one call
at the path's shapes, after a warm-up call. Beside each: its bound (the least time
the card could take: bytes over the memory rate or operations over the peak
rate of their type, cuvs_tpu_torch/bench/roofline.py), its share of that
bound, and for the brute-force kernels the time of the cuBLAS product of the
same operands alone (``product_ms``, a yardstick no kernel calls). No single
PyTorch call computes any kernel's function, so ``library_ms`` is null.

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
import tempfile
import threading
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
N, NQ, K, CAND = 1_000_000, 4096, 10, 40
N_LISTS, N_PROBES = 1984, 64  # bench.py's n_lists rule at 1M rows
Q_LISTS, Q_PROBES = 1024, 50  # IVF-PQ, IVF-RaBitQ, IVF-SQ (bench/configs/*.yaml base)
DEEP_K = 100  # phases 5-6's deep-bin searches: the other k of ann-benchmarks and cuvs-bench
CLI_LISTS, CLI_PROBES = 1024, 100  # the bench CLI's f32 IVF-Flat (configs/ivf_flat.yaml)
N_FIRST, SLICE = 900_000, 100_000  # extend phases: build on the first rows; streaming slices
SUB = 100_000  # the rows of the long tail's phases that are quadratic in n or host-bound
# the rows of CAGRA's merged halves (phase 24), the ACE build (25), the iterative build (26),
# the Vamana build (27) and the sharded CAGRA (34): at 1M, 1M, 100,000, 250,000 and 1M rows
# (8.8, 21.3, 36.6, 12.8 and 8.5 s on an H100) they took the script with phases 40-48 past
# its 420 s budget; 500,000 and 25,000 rows (4.3, 9.8, 12.0 and 6.6 s) left it 0.6 s under
# that budget on a slow host once phase 6 gained the IVF-PQ code widths
PART_ROWS = 300_000
ITER_ROWS = 12_500
L1_ROWS = 20_000  # the rows of phase 47's pointwise-tail (L1) sparse search
VAMANA_ROWS = 100_000
FLOAT_RTOL, FLOAT_ATOL, ID_MISMATCH = 1e-4, 1e-3, 1e-3
RECALL_SLACK = 0.005
TRACED_SEARCHES = 5  # phase 49's IVF-PQ searches under the profiler (the median is read)
# the beam search of the benchmark's CAGRA cell: 10,000 queries in one chunk at itopk 128,
# width 1, over f32 rows and a degree-64 graph (phase 19 runs it on phase 18's graph)
CELL_NQ = 10_000
CELL_BEAM = "float32-float32-itopk128-w1-deg64"


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
    from cuvs_tpu_torch.ops import bf_topk, cagra_beam, ivf_scan, pool_topk

    # name, module, wrapper, plain version, source, TPU kernel it replaces (None: the
    # reference has no Pallas kernel there)
    return [
        ("bf_topk_exact", bf_topk, "bf_topk_exact", "bf_topk_exact_reference",
         "cuvs_tpu_torch/csrc/bf_topk.cu", "cuvs_tpu/ops/bf_topk_pallas.py:44"),
        ("bf_topk_approx", bf_topk, "bf_topk_approx", "bf_topk_approx_reference",
         "cuvs_tpu_torch/csrc/bf_topk.cu", "cuvs_tpu/ops/bf_topk_pallas.py:90"),
        ("ivf_scan", ivf_scan, "fused_ivf_scan", "fused_ivf_scan_reference",
         "cuvs_tpu_torch/csrc/ivf_scan.cu", "cuvs_tpu/ops/ivf_scan_pallas.py:56"),
        ("pq_scan", ivf_scan, "fused_pq_scan", "fused_pq_scan_reference",
         "cuvs_tpu_torch/csrc/pq_scan.cu", "cuvs_tpu/ops/ivf_scan_pallas.py:195"),
        ("pool_topk", pool_topk, "pool_topk", "pool_topk_reference",
         "cuvs_tpu_torch/csrc/pool_topk.cu", None),
        ("cagra_beam", cagra_beam, "beam_search", "beam_search_reference",
         "cuvs_tpu_torch/csrc/cagra_beam.cu", None),
    ]


def launch_counts():
    """Each kernel's launches since its counter was last zeroed."""
    return {name: mod.LAUNCHES[name] for name, mod, *_ in kernels()}


def variant(name, args, kw):
    """The variant of a kernel call: the quantized scan's mode and table type
    (RaBitQ: its bits per code; IVF-PQ past 8 bits: its width too, as
    ``pq-bf16-4bit``), the pool merge's offsets and fetch (``offs-fetch40``,
    ``flat-fetch10``), the beam search's rows, compute type, itopk, width and
    degree (``float32-float32-itopk128-w1-deg64``), else the dtype of the
    first argument (queries or rows)."""
    if name == "pool_topk":
        return f"{'flat' if args[3] is None else 'offs'}-fetch{args[4]}"
    if name == "cagra_beam":
        rows, graph, state_v, width, compute = args[0], args[2], args[5], args[7], args[11]
        return (f"{str(rows.dtype).replace('torch.', '')}-{str(compute).replace('torch.', '')}"
                f"-itopk{state_v.shape[1]}-w{width}-deg{graph.shape[1]}")
    if name == "pq_scan":
        from cuvs_tpu_torch.bench.scan_compare import pq_variant

        return pq_variant(kw)
    return str(args[0].dtype).replace("torch.", "")


@contextlib.contextmanager
def recording(calls, counts):
    """Record each wrapper's arguments: the last call per kernel and variant,
    and the number of calls per kernel and variant in ``counts``. Yields
    ``tagged(suffix)``, a context inside which calls are recorded apart, under
    their variant + suffix, keeping the first call (a build's first batch is a
    full one)."""
    tag = [""]

    @contextlib.contextmanager
    def tagged(suffix):
        tag[0] = suffix
        try:
            yield
        finally:
            tag[0] = ""

    saved = []
    for name, mod, wrapper, _, _, _ in kernels():
        fn = getattr(mod, wrapper)

        def rec(*args, _fn=fn, _name=name, **kw):
            key = (_name, variant(_name, args, kw) + tag[0])
            counts[key] = counts.get(key, 0) + 1
            if not tag[0] or key not in calls:
                calls[key] = (args, kw)
            return _fn(*args, **kw)

        saved.append((mod, wrapper, fn))
        setattr(mod, wrapper, rec)
    try:
        yield tagged
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


def compare_pools(kernel_out, plain_out, kind):
    """Hold a kernel's pool against its plain version's. kind: "int" (int8
    rows: bit-identical), "exact" (the pool merge's selection: values bit for
    bit, columns equal), "float", or "int8lut" (float, except <= 0.1% of
    entries where a table entry rounded the other way). Returns (max abs
    error over the finite entries, bit-identical?)."""
    import torch

    kv, ki = kernel_out
    rv, ri = plain_out
    check(kv.shape == rv.shape and ki.shape == ri.shape, "pool shapes differ")
    if kind == "exact":
        check(torch.equal(kv.view(torch.int32), rv.view(torch.int32)) and torch.equal(ki, ri),
              "pool top-k selection is not bit-identical")
        return 0.0, True
    identical = torch.equal(kv, rv) and torch.equal(ki, ri)
    if kind == "int":
        check(identical, "int8 pool is not bit-identical")
        return 0.0, True
    fin = torch.isfinite(rv)
    check(torch.equal(fin, torch.isfinite(kv)), "pools differ in their empty entries")
    err = (kv[fin] - rv[fin]).abs()
    close = err <= FLOAT_ATOL + FLOAT_RTOL * rv[fin].abs()
    far = float((~close).float().mean()) if close.numel() else 0.0
    check(far <= (ID_MISMATCH if kind == "int8lut" else 0.0),
          f"pool values differ beyond tolerance at {far:.2e} of entries "
          f"(max abs err {float(err.max())})")
    mism = float((ki != ri).float().mean())
    check(mism <= ID_MISMATCH, f"pool ids differ at {mism:.2e} of entries")
    return (float(err.max()) if err.numel() else 0.0), identical


def compare_walks(kernel_out, plain_out):
    """Hold the beam kernel's final lists against the loop's: the ids of at
    least 99% of (query, slot) entries equal (a near-tie summed in another
    order may steer a beam elsewhere, and with bf16 operands ties are
    common), the distances within FLOAT_RTOL / FLOAT_ATOL where the ids
    agree, and the walk's steps, parents and scored children, summed over
    the queries, within 1% of the loop's (a query may reach the same list
    by another path). Returns (max abs error where the ids agree,
    bit-identical?)."""
    import torch

    (kv, ki, kc), (rv, ri, rc) = kernel_out, plain_out
    check(kv.shape == rv.shape and ki.shape == ri.shape and kc.shape == rc.shape,
          "beam lists' shapes differ")
    same = ki == ri
    share = float(same.float().mean())
    check(share >= 0.99, f"beam lists: ids equal on {share:.4f} of the entries, below 0.99")
    a, b = kv[same], rv[same]
    fin = torch.isfinite(b)
    check(torch.equal(fin, torch.isfinite(a)), "beam lists differ in their +inf entries")
    err = (a[fin] - b[fin]).abs()
    check(bool((err <= FLOAT_ATOL + FLOAT_RTOL * b[fin].abs()).all()),
          f"beam distances differ beyond tolerance (max abs err {float(err.max())})")
    ks, rs = kc.double().sum(0), rc.double().sum(0)
    check(bool(((ks - rs).abs() <= 0.01 * rs).all()),
          f"beam walk counts {ks.tolist()} differ from the loop's {rs.tolist()} by over 1%")
    print(f"# cagra_beam: counts equal on {float((kc == rc).all(1).float().mean()):.4f} of "
          f"the queries, ids on {share:.4f} of the entries")
    identical = torch.equal(kv, rv) and torch.equal(ki, ri) and torch.equal(kc, rc)
    return (float(err.max()) if err.numel() else 0.0), identical


@contextlib.contextmanager
def timed_calls(targets, times):
    """Wrap each (module, function) so every call is timed to its end on the
    card: times[name] = (seconds, last output, calls), seconds summed over
    calls."""
    import torch

    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def timed(*args, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            secs, _, count = times.get(_name, (0.0, None, 0))
            times[_name] = (secs + time.time() - t0, out, count + 1)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_graph(graph, n, what):
    """Every id in [0, n), no self edge, no repeat within a row."""
    import torch

    check(bool(((graph >= 0) & (graph < n)).all()), f"{what}: ids outside [0, n)")
    rows = torch.arange(graph.shape[0], device=graph.device)[:, None]
    check(not bool((graph == rows).any()), f"{what}: self edges")
    s = torch.sort(graph, dim=1).values
    check(not bool((s[:, 1:] == s[:, :-1]).any()), f"{what}: repeated ids within a row")


def without_self(ids, rows, k):
    """The first k ids of each row of ``ids`` other than its own id, rows[i]."""
    import torch

    order = torch.argsort((ids == rows[:, None]).to(torch.int8), dim=1, stable=True)[:, :k]
    return torch.gather(ids, 1, order)


def pairwise_inputs(metric, gen, m, d):
    """Inputs each metric is meant for (on the host): packed bits, (lat, lon)
    pairs, probability rows, 0/1 rows, or signed floats."""
    import torch

    from cuvs_tpu_torch.distance.pairwise import DistanceType as T

    if metric == T.BitwiseHamming:
        return [torch.randint(0, 256, (m, d), generator=gen, dtype=torch.uint8) for _ in "xy"]
    if metric == T.Haversine:
        scale = torch.tensor([3.14159, 6.28318])
        return [(torch.rand((m, 2), generator=gen) - 0.5) * scale for _ in "xy"]
    if metric in (T.JensenShannon, T.KLDivergence, T.HellingerExpanded):
        out = [torch.rand((m, d), generator=gen) + 0.01 for _ in "xy"]
        return [a / a.sum(1, keepdim=True) for a in out]
    if metric in (T.HammingUnexpanded, T.JaccardExpanded, T.DiceExpanded, T.RusselRaoExpanded):
        return [(torch.rand((m, d), generator=gen) > 0.5).float() for _ in "xy"]
    return [torch.randn((m, d), generator=gen) for _ in "xy"]


def index_bytes(index) -> int:
    """Bytes of the tensors an index holds."""
    from cuvs_tpu_torch.utils.device import map_tensors

    sizes = []
    map_tensors(index, lambda t: sizes.append(t.numel() * t.element_size()) or t)
    return sum(sizes)


def check_same_ranking(d_a, i_a, d_b, i_b, what, rtol=1e-5, atol=0.0):
    """Distances within rtol (+ atol); ids equal wherever the distance at that
    rank does not tie (within the same tolerance) a neighbouring rank's."""
    import torch

    d_a, d_b = d_a.double().cpu(), d_b.double().cpu()
    check(torch.allclose(d_a, d_b, rtol=rtol, atol=atol), f"{what}: distances differ")
    close = (d_b[:, 1:] - d_b[:, :-1]).abs() <= rtol * d_b[:, 1:].abs() + atol
    tied = torch.zeros_like(d_b, dtype=torch.bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    tied[:, -1] = True  # the last rank may tie a candidate that did not make the cut
    check(bool(((i_a.cpu() == i_b.cpu()) | tied).all()), f"{what}: ids differ at untied ranks")


@contextlib.contextmanager
def calls_of(mod, name, store):
    """Append the arguments (args, kw) of every call of mod.name to store."""
    fn = getattr(mod, name)

    def spy(*args, **kw):
        store.append((args, kw))
        return fn(*args, **kw)

    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def tfidf_csr(rng, rows, cols=32768, nnz=64, s=1.1, draws=160):
    """A TF-IDF-like CSR matrix: per row ``nnz`` distinct columns drawn by a
    Zipf law of exponent ``s`` over the columns (column r has weight
    1 / (r + 1)^s; draws with replacement, the first ``nnz`` distinct kept:
    sampling without repeats), values uniform in [0.1, 1) times the column's
    idf, log(1 / weight share)."""
    import numpy as np
    import scipy.sparse as sp

    p = 1.0 / np.arange(1, cols + 1) ** s
    p /= p.sum()
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    d = np.searchsorted(cdf, rng.random((rows, draws)))
    key = np.sort(d * draws + np.arange(draws), axis=1)  # by column, then draw order
    first = np.ones(key.shape, bool)
    first[:, 1:] = key[:, 1:] // draws != key[:, :-1] // draws
    pos = np.sort(np.where(first, key % draws, draws), axis=1)[:, :nnz]
    check(bool((pos < draws).all()), "tfidf_csr: a row drew fewer distinct columns than nnz")
    idx = np.sort(np.take_along_axis(d, pos, axis=1), axis=1)
    vals = (rng.uniform(0.1, 1.0, idx.shape) * -np.log(p[idx])).astype(np.float32)
    return sp.csr_matrix((vals.reshape(-1), idx.reshape(-1).astype(np.int32),
                          np.arange(0, rows * nnz + 1, nnz)), shape=(rows, cols))


def long_tail(dev, smi, ds, x, q, gti, d2, i2, exact_qps):
    """Phases 40-48: the long tail on the 1M rows, or on their first SUB rows
    where a module is quadratic in n or host-bound. Each prints its seconds
    and its device-memory peak above what is held; any failed check raises."""
    import numpy as np
    import scipy.linalg
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    import torch

    from cuvs_tpu_torch import capi
    from cuvs_tpu_torch.bench.gt import id_recall
    from cuvs_tpu_torch.cluster import agglomerative, kmeans
    from cuvs_tpu_torch.cluster import spectral as spectral_cluster
    from cuvs_tpu_torch.distance import kernels, pairwise
    from cuvs_tpu_torch.neighbors import (ball_cover, brute_force, cross_component,
                                          epsilon_neighborhood, knn_graph)
    from cuvs_tpu_torch.neighbors import sparse_brute_force as sbf
    from cuvs_tpu_torch.preprocessing import pca
    from cuvs_tpu_torch.preprocessing import spectral
    from cuvs_tpu_torch.stats import silhouette_score, trustworthiness_score

    n, dim = x.shape
    xs = x[:SUB]

    step_peaks = []  # the absolute peaks that step_peak() read before resetting

    @contextlib.contextmanager
    def phase(label):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step_peaks.clear()
        t0 = time.time()
        yield
        torch.cuda.synchronize()
        peak = (max(step_peaks + [torch.cuda.max_memory_allocated(dev)]) - held) / 2**30
        print(f"# phase {label}: {time.time() - t0:.1f} s, peak {peak:.2f} GiB above the "
              f"{held / 2**30:.2f} GiB held ({smi})")

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def step_peak():
        """GiB allocated at the peak since the last reset, above what was held
        then; resets the peak (the phase's own peak keeps it)."""
        step_peaks.append(torch.cuda.max_memory_allocated(dev))
        peak = step_peaks[-1] - step_held[0]
        torch.cuda.synchronize()
        step_held[0] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        return peak / 2**30

    step_held = [torch.cuda.memory_allocated(dev)]

    def near_eps_only(a, b, dist, eps, rel, what):
        differ = a != b
        check(bool((dist[differ] - eps).abs().le(rel * eps).all()),
              f"{what}: adjacencies differ away from eps")
        return int(differ.sum())

    sq_atol = 8 * float(torch.finfo(torch.float32).eps) * 2 * float((x * x).sum(1).max())
    eps = float(torch.sqrt(d2[:, K - 1].double()).median())
    t40 = time.time()
    # 40. ball cover on the 1M rows: build, knn_query (two passes), eps_nn, all_knn_query
    with phase("40 ball cover"):
        step_peak()
        bc, secs = synced(lambda: ball_cover.build(x, seed=0))
        print(f"# ball cover build: {bc.inner.n_lists} landmarks, window {bc.inner.window}, "
              f"largest radius {float(bc.radii.max()):.1f} ({secs:.1f} s, peak {step_peak():.2f} "
              "GiB)")
        masks = []
        with calls_of(ball_cover, "_masked_full_scan", masks):
            (bd, bi), secs = synced(lambda: ball_cover.knn_query(bc, q, K))
        rec = id_recall(bi.cpu(), gti)
        share = float(masks[1][0][3].float().mean())
        cells2 = int(masks[1][0][3].any(0).sum())
        print(f"# ball cover knn_query, {q.shape[0]} queries, k={K}, two passes: "
              f"recall@10={rec:.4f} qps={q.shape[0] / secs:.0f} ({secs:.2f} s, peak "
              f"{step_peak():.2f} GiB); pass 2 scans {share:.4f} of the (query, cell) pairs, "
              f"{cells2} of {bc.inner.n_lists} cells for some query")
        check(rec >= 0.999, f"ball cover recall@10 {rec:.4f} below 0.999")
        check(torch.allclose(bd.double(), torch.sqrt(d2.double()), rtol=1e-3, atol=1e-3),
              "ball cover distances differ from the square roots of phase 2's beyond rtol 1e-3")
        qe = q[:256]
        del masks
        (adj, deg), secs = synced(lambda: ball_cover.eps_nn(bc, qe, eps))
        eps_peak = step_peak()
        (want, wdeg), wsecs = synced(lambda: epsilon_neighborhood.eps_neighbors(qe, x, eps))
        want_peak = step_peak()
        dist = pairwise.pairwise_distance(qe, x, metric="euclidean")
        flips = near_eps_only(adj, want, dist, eps, 1e-4, "ball cover eps_nn against eps_neighbors")
        check(torch.equal(deg, adj.sum(1, dtype=torch.int32)), "eps_nn degrees")
        dq = deg.float().quantile(torch.tensor([0.0, 0.5, 1.0], device=dev)).tolist()
        print(f"# ball cover eps_nn, 256 queries, eps {eps:.3f} (median 10th-neighbour distance): "
              f"{secs:.2f} s (eps_neighbors {wsecs:.2f} s); equal to eps_neighbors but {flips} "
              f"entries within 1e-4 of eps; degrees min/median/max {dq[0]:.0f}/{dq[1]:.0f}/"
              f"{dq[2]:.0f}; peaks: eps_nn {eps_peak:.2f} GiB, eps_neighbors {want_peak:.2f} "
              f"GiB, the check {step_peak():.2f} GiB")
        del dist, want, adj, bd, bi
        step_peak()  # what the freed tensors held is not the next step's baseline
        bcs, secs = synced(lambda: ball_cover.build(xs, seed=0))
        (ad, ai), asecs = synced(lambda: ball_cover.all_knn_query(bcs, K))
        all_peak = step_peak()
        rows = bcs.inner.sorted_data[:SUB, :dim]
        bf_sub = brute_force.build(xs)
        (ed, ei), esecs = synced(lambda: brute_force.search(bf_sub, rows, K))
        self_peak = step_peak()
        check_same_ranking(ad.double() ** 2, ai, ed, ei,
                           "ball cover all_knn_query against an exact self-search", rtol=1e-5,
                           atol=sq_atol)
        print(f"# ball cover all_knn_query on {SUB} rows ({bcs.inner.n_lists} landmarks, window "
              f"{bcs.inner.window}, build {secs:.2f} s): {asecs:.2f} s (peak {all_peak:.2f} GiB), "
              f"equal to an unfused exact self-search ({esecs:.2f} s, peak {self_peak:.2f} GiB) "
              f"but at ties (the check's peak {step_peak():.2f} GiB)")
        del bc, bcs, bf_sub, rows, ad, ai, ed, ei
    # the C library, its two programs, and c_test started on the host beside phases 41-48
    # (the whole ABI through cuvsTpuInit("cpu"), two threads): it is collected in phase 48
    t0 = time.time()
    capi_tmp = tempfile.TemporaryDirectory()
    walk = None
    try:
        programs = build_capi_programs(capi_tmp.name)
        walk = subprocess.Popen([programs[1]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, cwd=capi_tmp.name,
                                env=dict(capi.program_env(), OMP_NUM_THREADS="2"))
        print(f"# C ABI: the port's C library and two programs built, c_test started on the "
              f"host ({time.time() - t0:.1f} s)")
        # 41. the epsilon neighbourhood of 1024 queries over the 1M rows ([1024, 1M] f32: 4 GiB)
        with phase("41 epsilon neighbourhood"):
            (adj, deg), secs = synced(lambda: epsilon_neighborhood.eps_neighbors(q[:1024], x, eps))
            check(adj.shape == (1024, n) and torch.equal(deg, adj.sum(1, dtype=torch.int32)),
                  "eps_neighbors: shape or degrees")
            print(f"# eps_neighbors 1024 x {n}: {secs:.2f} s, mean degree "
                  f"{float(deg.float().mean()):.1f}")
            del adj, deg
        # 42. single linkage of the first SUB rows (15 neighbours, 16 clusters)
        with phase("42 single linkage"):
            split = {}
            targets = [(knn_graph, "build_knn_graph"), (agglomerative, "_boruvka_forest"),
                       (agglomerative, "_boruvka_round"), (agglomerative, "_connect_smallest"),
                       (agglomerative, "_mst_edges")]
            with timed_calls(targets, split):
                sl, secs = synced(lambda: agglomerative.single_linkage(xs, n_clusters=16,
                                                                       n_neighbors=15))
            sec = {key: v[0] for key, v in split.items()}
            repair = split.get("_connect_smallest", (0.0, None, 0))
            rest = sec["_mst_edges"] - sec["build_knn_graph"] - sec["_boruvka_forest"] - repair[0]
            print(f"# single linkage {SUB} rows: {secs:.1f} s = knn graph "
                  f"{sec['build_knn_graph']:.2f} + Borůvka {sec['_boruvka_forest']:.2f} "
                  f"({split['_boruvka_round'][2]} rounds) + "
                  f"repair {repair[0]:.2f} ({repair[2]} rounds) + the rest of the MST {rest:.2f} + "
                  f"dendrogram {secs - sec['_mst_edges']:.2f}")
            nbrs, dists = split["build_knn_graph"][1]
            kk = nbrs.shape[1]
            u = np.repeat(np.arange(SUB), kk)
            v = nbrs.cpu().numpy().reshape(-1)
            w = np.maximum(dists.float().cpu().numpy().reshape(-1), 1e-30)
            mask = split["_boruvka_forest"][1].cpu().numpy()
            g = sp.csr_matrix((w.astype(np.float64), (u, v)), shape=(SUB, SUB))
            g = g.maximum(g.T)
            n_comp = csg.connected_components(g, directed=False)[0]
            mst_w = float(csg.minimum_spanning_tree(g).sum())
            forest_w = float(w[mask].astype(np.float64).sum())
            print(f"# Borůvka forest: {int(mask.sum())} edges, weight {forest_w:.6g}; scipy's "
                  f"MST of the symmetrized knn edges: {SUB - n_comp} edges ({n_comp} components), weight "
                  f"{mst_w:.6g}")
            check(int(mask.sum()) == SUB - n_comp,
                  "Borůvka forest: edge count differs from scipy's")
            check(abs(forest_w - mst_w) <= 1e-5 * mst_w,
                  "Borůvka forest: weight differs from scipy's")
            check(sl.dendrogram.shape == (SUB - 1, 2) and len(sl.distances) == SUB - 1,
                  "single linkage: not n - 1 merges")
            check(bool((np.diff(sl.distances) >= 0).all()), "single linkage: heights do not ascend")
            check(len(np.unique(sl.labels)) == 16, "single linkage: not 16 labels")
            del nbrs, dists, split
        # 43. cross-component nearest neighbours over phase 42's 16 labels
        with phase("43 cross-component NN"):
            edges, secs = synced(lambda: cross_component.cross_component_nn(xs, sl.labels))
            src, dst = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
            check(edges.shape == (16, 3) and bool((sl.labels[src] != sl.labels[dst]).all()),
                  "cross-component edges: an edge within one component")
            xh = xs.double().cpu().numpy()
            exact = ((xh[src] - xh[dst]) ** 2).sum(1)
            check(np.allclose(edges[:, 2], exact, rtol=1e-4), "cross-component distances differ "
                  "from a float64 recomputation")
            sizes = np.bincount(sl.labels)
            c = int(np.argmin(sizes))
            inside = torch.from_numpy(np.flatnonzero(sl.labels == c)).to(dev)
            outside = torch.from_numpy(np.flatnonzero(sl.labels != c)).to(dev)
            nearest = float(torch.cdist(xs[inside].double(), xs[outside].double()).min()) ** 2
            check(nearest >= edges[c, 2] * (1 - 1e-4), "cross-component: an outside row is nearer "
                  "than the smallest component's edge")
            print(f"# cross_component_nn over 16 components (sizes {sizes.min()}..{sizes.max()}): "
                  f"{secs:.2f} s; every edge joins two components, distances = float64 "
                  f"recomputation; no outside row nearer to component {c} ({sizes[c]} rows)")
        # 44. spectral embedding (LOBPCG at this n) and spectral clustering of the first SUB rows
        with phase("44 spectral"):
            split = {}
            with timed_calls([(knn_graph, "build_knn_graph"), (spectral, "_lobpcg_standard"),
                              (kmeans, "fit")], split):
                (labels, emb), secs = synced(lambda: spectral_cluster.fit_predict(xs, 8, seed=0))
            theta, u, iters = split["_lobpcg_standard"][1]
            print(f"# spectral fit_predict {SUB} rows, 8 clusters: {secs:.1f} s (knn graph "
                  f"{split['build_knn_graph'][0]:.1f}, LOBPCG "
                  f"{split['_lobpcg_standard'][0]:.1f} s for "
                  f"{iters} iterations, k-means {split['fit'][0]:.1f})")
            check(emb.shape == (SUB, 8) and bool(torch.isfinite(emb).all()), "spectral embedding")
            check(int(labels.min()) >= 0 and int(labels.max()) < 8, "spectral labels")
            nbrs = split["build_knn_graph"][1][0].long()
            rows_ = torch.arange(SUB, device=dev).repeat_interleave(nbrs.shape[1])
            s_, d_ = torch.cat([rows_, nbrs.reshape(-1)]), torch.cat([nbrs.reshape(-1), rows_])
            dinv = 1.0 / torch.sqrt(torch.clamp_min(torch.zeros(SUB, device=dev).index_add_(
                0, s_, torch.ones_like(s_, dtype=torch.float32)), 1.0))
            order = torch.argsort(-theta, stable=True)
            uu = u[:, order][:, 1:9].double()
            mv = uu + dinv[:, None].double() * torch.zeros_like(uu).index_add_(
                0, s_, (uu * dinv[:, None].double())[d_])  # (2I - L_norm) u
            th = theta[order][1:9].double()
            resid = torch.linalg.norm(th[None, :] * uu - mv, dim=0) / torch.linalg.norm(uu, dim=0)
            lam = 2.0 - th
            print(f"# spectral eigenvalues of L_norm {', '.join(f'{float(v):.5f}' for v in lam)}; "
                  f"residuals |L v - lambda v| / |v| max {float(resid.max()):.2e}")
            check(bool((resid < 1e-2).all()), "spectral: an eigen-residual of 1e-2 or more")
            check(bool(((lam >= -1e-5) & (lam <= 2 + 1e-5)).all()),
                  "spectral: an eigenvalue outside [0, 2]")
            del split, nbrs, s_, d_, uu, mv
            x4 = x[:4096]
            dense, secs = synced(lambda: spectral.spectral_embedding(x4, n_components=8))
            src, dst = spectral._sym_knn_edges(x4, 15, "euclidean")
            adj = np.zeros((4096, 4096))
            adj[src.cpu().numpy(), dst.cpu().numpy()] = 1.0
            adj = np.maximum(adj, adj.T)
            dh = 1.0 / np.sqrt(np.maximum(adj.sum(1), 1e-12))
            t0 = time.time()
            # float64 LAPACK (dsyevr) on the host, the 10 smallest pairs only
            evals, evecs = scipy.linalg.eigh(np.eye(4096) - dh[:, None] * adj * dh[None, :],
                                             subset_by_index=[0, 9])
            host_s = time.time() - t0
            ref = evecs[:, 1:9] * dh[:, None]
            ref /= np.maximum(np.linalg.norm(ref, axis=0, keepdims=True), 1e-12)
            got = dense.double().cpu().numpy()
            # an f32 eigenvector is off by about eps * |L| / gap (Davis-Kahan): columns whose
            # eigenvalue is 1e-2 from its neighbours' are held to atol 1e-4
            gaps = np.diff(evals[:10])
            sep = [c for c in range(8) if min(gaps[c], gaps[c + 1]) > 1e-2]
            errs = [float(np.abs(np.sign((got[:, c] * ref[:, c]).sum()) * got[:, c]
                                 - ref[:, c]).max()) for c in sep]
            print(f"# dense spectral embedding of 4096 rows ({secs:.2f} s) against "
                  f"scipy.linalg.eigh in float64 on the host ({host_s:.1f} s): "
                  f"{len(sep)} of 8 columns with separated eigenvalues, max abs error up to sign "
                  f"{max(errs, default=0.0):.2e}")
            check(len(sep) > 0 and max(errs) <= 1e-4, "dense spectral embedding differs from the "
                  "host's float64 eigh beyond atol 1e-4")
        # 45. PCA of the 1M rows to 32 components
        with phase("45 PCA"):
            p, secs = synced(lambda: pca.fit(x, 32))
            xd = x.double()
            xc = xd - xd.mean(0)
            w64, v64 = np.linalg.eigh((xc.T @ xc / (n - 1)).cpu().numpy())
            del xd, xc
            w64, v64 = w64[::-1][:32], v64[:, ::-1][:, :32]
            check(np.allclose(p.explained_variance.double().cpu().numpy(), w64, rtol=1e-4),
                  "PCA explained variance differs from the float64 covariance's eigenvalues")
            comp = p.components.double().cpu().numpy()
            sep = np.ones(32, bool)
            gaps = np.abs(np.diff(w64)) > 1e-3 * w64[0]
            sep[:-1] &= gaps
            sep[1:] &= gaps
            signs = np.sign((comp * v64.T).sum(1))
            cerr = float(np.abs(comp * signs[:, None] - v64.T)[sep].max())
            recon = pca.inverse_transform(p, pca.transform(p, x))
            rel = float(torch.linalg.norm(recon - x) / torch.linalg.norm(x - p.mean))
            print(f"# PCA {n} x {dim} -> 32: {secs:.2f} s; explained variance = float64 eigh "
                  f"(rtol 1e-4); {int(sep.sum())} separated components up to sign, max abs error "
                  f"{cerr:.2e}; relative reconstruction error {rel:.4f}")
            check(cerr <= 1e-3, "PCA components differ from float64 eigh's beyond 1e-3")
            del recon
        # 46. silhouette, trustworthiness, the Gram kernels and KDE, card against the CPU
        with phase("46 stats and kernels"):
            _, klabels, _, _ = kmeans.fit(xs, n_clusters=64, seed=0)
            sil, secs = synced(lambda: silhouette_score(xs, klabels, 64))
            s_card = float(silhouette_score(xs[:20000], klabels[:20000], 64))
            s_cpu = float(silhouette_score(xs[:20000].cpu(), klabels[:20000].cpu(), 64))
            check(abs(s_card - s_cpu) <= 1e-4 * abs(s_cpu), "silhouette: card differs from the CPU")
            emb10 = pca.transform(p, x[:10000])
            tw, tsecs = synced(lambda: trustworthiness_score(x[:10000], emb10))
            tw_cpu = float(trustworthiness_score(x[:10000].cpu(), emb10.cpu()))
            check(abs(float(tw) - tw_cpu) <= 1e-5 * tw_cpu,
                  "trustworthiness: card differs from the CPU")
            print(f"# silhouette of {SUB} rows under 64 k-means clusters {float(sil):.5f} "
                  f"({secs:.2f} s; its first 20,000 rows: card {s_card:.6f}, CPU {s_cpu:.6f}); "
                  "trustworthiness of the PCA-32 "
                  f"projection of 10,000 rows {float(tw):.6f} ({tsecs:.2f} s; = CPU)")
            gamma = 1.0 / float((xs * xs).sum(1).mean())
            gram_kw = {kernels.KernelType.LINEAR: {},
                       kernels.KernelType.POLYNOMIAL: dict(gamma=gamma, coef0=1.0, degree=3),
                       kernels.KernelType.RBF: dict(gamma=1.0 / eps ** 2),
                       kernels.KernelType.TANH: dict(gamma=gamma, coef0=0.1)}
            times = []
            for kern, kw in gram_kw.items():
                g_, secs = synced(lambda: kernels.gram_matrix(q, xs, kern, **kw))
                ref = kernels.gram_matrix(q[:16].cpu(), xs.cpu(), kern, **kw)
                scale = float(ref.abs().max())
                check(g_.shape == (q.shape[0], SUB) and torch.allclose(
                    g_[:16].cpu(), ref, rtol=1e-5, atol=1e-6 * scale), f"gram {kern.name}: card "
                    "differs from the CPU")
                times.append(f"{kern.name} {secs * 1e3:.1f} ms")
                del g_
            print(f"# gram matrices 4096 x {SUB} ({', '.join(times)}), rows 0-15 = CPU")
            times = []
            xh_all = x.cpu()
            for kern in kernels.DensityKernelType:
                dens, secs = synced(lambda: kernels.kde(q[:1024], x, bandwidth=eps, kernel=kern))
                ref = kernels.kde(q[:8].cpu(), xh_all, bandwidth=eps, kernel=kern)
                # Tophat steps at the bandwidth: a sample within rounding of it may count either way
                at_edge = 0.0
                if kern == kernels.DensityKernelType.Tophat:
                    rel = pairwise.pairwise_distance(q[:8], x, metric="euclidean") / eps - 1.0
                    at_edge = float(rel.abs().le(1e-5).sum(1).max())
                check(torch.allclose(dens[:8].cpu(), ref, rtol=1e-5, atol=at_edge),
                      f"kde {kern.name}: card differs from the CPU")
                times.append(f"{kern.name} {secs * 1e3:.1f} ms")
            print(f"# kde of 1024 queries over {n} rows, bandwidth {eps:.3f} ({', '.join(times)}), "
                  "queries 0-7 = CPU")
            del xh_all, dens, emb10
        # 47. sparse brute force on a TF-IDF-like CSR (100,000 x 32,768, 64 non-zeros a row)
        with phase("47 sparse brute force"):
            rng = np.random.default_rng(0)
            t0 = time.time()
            xcsr = tfidf_csr(rng, SUB)
            qcsr = tfidf_csr(rng, 1024)
            print(f"# TF-IDF-like CSR {xcsr.shape[0]} x {xcsr.shape[1]}, {xcsr.nnz} non-zeros, "
                  f"1024 queries, Zipf 1.1 columns ({time.time() - t0:.1f} s)")
            nh = 128
            for metric in ("inner_product", "cosine"):
                index = sbf.from_scipy(xcsr, metric=metric)
                (sd, si), secs = synced(lambda: sbf.search(index, qcsr.indptr, qcsr.indices,
                                                           qcsr.data, K))
                dots = (qcsr[:nh] @ xcsr.T).toarray().astype(np.float64)
                if metric == "cosine":
                    qn = np.sqrt(qcsr[:nh].multiply(qcsr[:nh]).sum(1).A)
                    xn = np.sqrt(xcsr.multiply(xcsr).sum(1).A).T
                    hd = 1.0 - dots / np.maximum(qn * xn, 1e-30)
                else:
                    hd = -dots
                hi = np.argsort(hd, axis=1, kind="stable")[:, :K]
                hdk = np.take_along_axis(hd, hi, axis=1)
                got = sd[:nh].double()
                check_same_ranking(-got if metric == "inner_product" else got, si[:nh],
                                   torch.from_numpy(hdk), torch.from_numpy(hi),
                                   f"sparse {metric} against scipy's product", rtol=1e-5,
                                   atol=1e-6)
                print(f"# sparse brute force {metric}, 1024 queries, k={K}: qps={1024 / secs:.0f} "
                      f"({secs:.2f} s); queries 0-{nh - 1} = scipy's product + argsort but at ties")
                del index, dots
            index = sbf.from_scipy(xcsr[:L1_ROWS], metric="l1")
            q256 = qcsr[:256]
            (sd, si), secs = synced(lambda: sbf.search(index, q256.indptr, q256.indices,
                                                       q256.data, K))
            with warnings.catch_warnings():  # torch's sparse CSR tensors are "beta"
                warnings.simplefilter("ignore", UserWarning)
                dense_x = torch.sparse_csr_tensor(index.indptr.cpu(), index.indices.cpu(),
                                                  index.data.cpu(), size=(index.size, index.n_cols),
                                                  check_invariants=True).to(dev).to_dense()
            dense_q = torch.from_numpy(q256.toarray()).to(dev)
            cd = torch.cdist(dense_q, dense_x, p=1.0)
            cv, ci = torch.sort(cd, dim=1, stable=True)
            check_same_ranking(sd, si, cv[:, :K], ci[:, :K], "sparse l1 against torch.cdist",
                               rtol=1e-5, atol=1e-6)
            print(f"# sparse brute force l1 (the pointwise tail), 256 queries x {index.size} rows: "
                  f"qps={256 / secs:.0f} ({secs:.2f} s); = torch.cdist(p=1) of the dense rows "
                  "but at ties")
            del index, dense_x, dense_q, cd, cv, ci
        print(f"# phases 40-47: {time.time() - t40:.1f} s")
        with phase("48 C ABI"):
            capi_phase(capi_tmp.name, programs[0], walk, t0, x, q, ds, d2, i2, exact_qps)
    finally:
        if walk is not None and walk.poll() is None:
            walk.kill()
            walk.wait()
        capi_tmp.cleanup()


def device_busy(trace_path):
    """(µs of the trace during which the card ran a kernel, a copy or a set:
    the union of those events' intervals; µs of device time per event name)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    return busy, by_name


def bench_cli_phase(dev, smi, ds, bf, pq, pq_sp, q, gti, results, tagged):
    """Phase 49: ``python -m cuvs_tpu_torch.bench`` in-process on the stand-in
    (1M x 128, its 10,000 queries, k = 10, ground truth of the first 1024),
    as a user runs it: (a) ``--config ivf_rabitq --group base`` (4 builds x 3
    probes), (b) ``--algo ivf_flat --algo ivf_pq`` at 1024 lists with the
    default grids (4 + 6 rows), (c) brute force fused, exact and f32
    approximate (2 rows). The CLI's loads of sift-128-euclidean return the
    script's own ``ds`` (the same seeded arrays; a load takes 4-5 s on the
    host). Its kernel calls are recorded under ``-cli`` variants. Then one f32
    approximate search of the 4096 queries (the kernels line's float32
    variant of ``bf_topk_approx``) and five IVF-PQ searches of the 10,000
    queries, each under the profiler (recorded under ``-trace``)."""
    import csv
    import io

    import torch

    from cuvs_tpu_torch.bench import __main__ as cli
    from cuvs_tpu_torch.bench import datasets
    from cuvs_tpu_torch.bench.gt import id_recall
    from cuvs_tpu_torch.neighbors import brute_force, ivf_pq
    from cuvs_tpu_torch.ops import bf_topk, ivf_scan
    from cuvs_tpu_torch.utils import tracing

    real_load = datasets.load

    def load(name, max_rows=None, seed=0):
        if name == "sift-128-euclidean" and (max_rows or N) >= N and seed == 0:
            return ds
        return real_load(name, max_rows=max_rows, seed=seed)

    columns = ["algo", "dataset", "build_s", "params", "recall", "qps", "latency_ms"]
    tmp = tempfile.TemporaryDirectory()
    before = launch_counts()
    runs = {"a": ["--config", "ivf_rabitq", "--group", "base"],
            "b": ["--algo", "ivf_flat", "--algo", "ivf_pq", "--build-params", '{"n_lists": 1024}'],
            "c": ["--algo", "brute_force", "--search-grid",
                  '{"fused": [true], "recall_target": [null, 0.97]}']}
    rows = {}
    datasets.load = load
    try:
        for key, argv in runs.items():
            out_csv = os.path.join(tmp.name, f"{key}.csv")
            printed = io.StringIO()
            t0 = time.time()
            with tagged("-cli"), contextlib.redirect_stdout(printed):
                rows[key] = cli.main(["--dataset", "sift-128-euclidean", "--cache-dir", tmp.name,
                                      "--csv", out_csv, *argv])
            check(printed.getvalue().splitlines() == [json.dumps(r.as_dict()) for r in rows[key]],
                  f"CLI ({key}): printed rows differ from the returned rows")
            with open(out_csv) as f:
                back = list(csv.DictReader(f))
            check(len(back) == len(rows[key]) and (not back or list(back[0]) == columns),
                  f"CLI ({key}): the CSV does not read back with the reference's columns")
            for r in rows[key]:
                print(f"# cli ({key}) {r.algo} {json.dumps(r.params)}: recall@10={r.recall:.4f} "
                      f"qps={r.qps:.0f} latency {r.latency_ms:.2f} ms, build {r.build_s:.2f} s")
            print(f"# cli ({key}): {len(rows[key])} rows in {time.time() - t0:.1f} s")
    finally:
        datasets.load = real_load
        tmp.cleanup()
    torch.cuda.synchronize()
    # the CLI's configurations run no graph search
    launched = {name: n - before[name] for name, n in launch_counts().items()
                if name != "cagra_beam"}
    print(f"# cli launches: {json.dumps(launched)}")
    check(all(n > 0 for n in launched.values()), f"the CLI left a kernel unlaunched: {launched}")
    check([len(rows[key]) for key in "abc"] == [12, 4 + 6, 2],
          f"CLI row counts {[len(rows[key]) for key in 'abc']}, expected [12, 10, 2]")

    # recall does not fall as n_probes grows, per build (and per refine ratio)
    groups = {}
    for r in rows["a"] + rows["b"]:
        build, search = (r.params["build"], r.params["search"]) if "build" in r.params else (
            None, r.params)
        key = (r.algo, json.dumps(build, sort_keys=True), search.get("refine_ratio"))
        groups.setdefault(key, []).append((search["n_probes"], r.recall))
    for key, pts in groups.items():
        pts.sort()
        check(all(b[1] >= a[1] - RECALL_SLACK for a, b in zip(pts, pts[1:])),
              f"CLI {key}: recall falls as n_probes grows: {pts}")
    exact, approx = rows["c"]
    check(exact.params == {"fused": True, "recall_target": None} and exact.recall >= 0.999,
          f"CLI brute force exact row: {exact.params} recall {exact.recall}")
    b3 = [r for r in rows["a"] if r.params == {"build": {"bits_per_dim": 3, "n_lists": 1024},
                                               "search": {"n_probes": 50}}]
    ref7 = results[f"ivf_rabitq_b3_p{Q_PROBES}"]["recall"]
    check(len(b3) == 1 and abs(b3[0].recall - ref7) <= 0.02,
          f"CLI RaBitQ 3 bits p50 recall {[r.recall for r in b3]} vs phase 7's {ref7:.4f}")
    print(f"# cli: RaBitQ 3 bits p50 recall {b3[0].recall:.4f} (1024 queries) against phase 7's "
          f"{ref7:.4f} (4096); brute force exact {exact.recall:.4f}, f32 approximate "
          f"{approx.recall:.4f}")

    # the f32 approximate kernel at the path's shape: recorded for the kernels line
    d, i = brute_force.search(bf, q, K, fused=True, recall_target=0.97)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(d).all()), "f32 approximate search: non-finite distances")
    rec = id_recall(i.cpu(), gti)
    check(rec >= 0.9, f"f32 approximate search recall {rec:.4f}")
    print(f"# bf_fused_f32_approx ({q.shape[0]} queries): recall@10={rec:.4f}")

    # IVF-PQ searches of the 10,000 queries: five untraced, then five each under the profiler
    q10 = torch.from_numpy(ds.queries.astype("float32")).to(dev)
    search = lambda: ivf_pq.search(pq, q10, K, pq_sp)  # noqa: E731
    untraced, traced = [], []
    trace_dir = tempfile.TemporaryDirectory()
    try:
        with tagged("-trace"):
            search()
            torch.cuda.synchronize()
            for _ in range(TRACED_SEARCHES):
                t0 = time.time()
                search()
                torch.cuda.synchronize()
                untraced.append(time.time() - t0)
            for _ in range(TRACED_SEARCHES):
                tracing.start_profiler_trace(trace_dir.name)
                t0 = time.time()
                search()
                torch.cuda.synchronize()
                wall = time.time() - t0
                traced.append((wall, *device_busy(tracing.stop_profiler_trace())))
    finally:
        trace_dir.cleanup()
    for _, _, by_name in traced:
        check(any("pq_scan_kernel" in n for n in by_name),
              f"a profiler trace names no pq_scan_kernel: {sorted(by_name)[:20]}")
    mid = TRACED_SEARCHES // 2
    wall, busy_us, by_name = sorted(traced, key=lambda t: t[1] / t[0])[mid]
    plain_wall = sorted(untraced)[mid]
    shares = ", ".join(f"{b / 1e3 / (w * 1e3):.3f}" for w, b, _ in traced)
    print(f"# ivf_pq p{Q_PROBES} search of {q10.shape[0]} queries: untraced wall median "
          f"{plain_wall * 1e3:.2f} ms of {TRACED_SEARCHES}; device busy / traced wall of "
          f"{TRACED_SEARCHES} searches under torch.profiler: {shares}; the median one: busy "
          f"{busy_us / 1e3:.2f} ms = {busy_us / 1e3 / (wall * 1e3):.3f} of its {wall * 1e3:.2f} "
          f"ms traced, {busy_us / 1e3 / (plain_wall * 1e3):.3f} of the untraced median; "
          f"{len(by_name)} device event names, pq_scan_kernel among them ({smi})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print("# that median traced search's device time by name: " + "; ".join(
        f"{n[:60]} {us / 1e3:.2f} ms" for n, us in top))


def build_capi_programs(tmp):
    """The port's C library and, in ``tmp``, the two programs of phase 48:
    ``csrc/capi_card_check.c`` and a copy of the untouched ``capi/c_test.c``
    whose /tmp/capi_ paths point into ``tmp``. Returns their paths."""
    from cuvs_tpu_torch import capi

    driver = capi.build_program(os.path.join(HERE, "cuvs_tpu_torch", "csrc", "capi_card_check.c"),
                                os.path.join(tmp, "capi_card_check"))
    with open(os.path.join(HERE, "capi", "c_test.c")) as f:
        src = f.read()
    with open(os.path.join(tmp, "c_test.c"), "w") as f:
        f.write(src.replace("/tmp/capi_", os.path.join(tmp, "capi_")))
    return driver, capi.build_program(os.path.join(tmp, "c_test.c"), os.path.join(tmp, "c_test"))


def capi_phase(tmp, driver, walk, t_walk, x, q, ds, d2, i2, exact_qps):
    """Phase 48: the C ABI on the card, in a subprocess (the port's C library
    embeds libpython, so it is never loaded into this process), then the
    c_test process started before phase 41."""
    import numpy as np
    import torch

    from cuvs_tpu_torch import capi
    from cuvs_tpu_torch.io import native

    base, queries = os.path.join(tmp, "base.fbin"), os.path.join(tmp, "queries.fbin")
    native.write_bin(base, x.cpu().numpy())
    native.write_bin(queries, q.cpu().numpy())
    ids, secs_path = os.path.join(tmp, "ids.bin"), os.path.join(tmp, "secs.txt")
    t0 = time.time()
    r = subprocess.run([driver, base, queries, ds.metric, str(K), ids, secs_path],
                       capture_output=True, text=True, env=capi.program_env(), timeout=300)
    driver_s = time.time() - t0
    check(r.returncode == 0, f"capi_card_check failed ({r.returncode}): {r.stdout} {r.stderr}")
    got = torch.from_numpy(np.fromfile(ids, np.int32).reshape(q.shape[0], K))
    with open(secs_path) as f:
        secs = float(f.read())
    same = float((got == i2.cpu()).float().mean())
    check_same_ranking(d2, got, d2, i2, "the C ABI's fused search against phase 2")
    print(f"# C ABI on the card: cuvsTpuInit(\"gpu\"), brute-force build + fused search of "
          f"{q.shape[0]} queries through cuvsTpuIndexSearch in {secs * 1e3:.1f} ms (phase 2's "
          f"search {q.shape[0] / exact_qps * 1e3:.1f} ms); ids = phase 2's but at ties "
          f"({same:.4f} equal; process {driver_s:.1f} s)")
    out, err = walk.communicate(timeout=300)
    check(walk.returncode == 0 and "C API smoke test PASSED" in out,
          f"c_test failed ({walk.returncode}): {out[-2000:]} {err[-2000:]}")
    print(f"# capi/c_test.c against the port's library (cuvsTpuInit(\"cpu\"), the whole ABI): "
          f"C API smoke test PASSED ({time.time() - t_walk:.1f} s after it started)")


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
    from cuvs_tpu_torch.bench import datasets, roofline, scan_compare
    from cuvs_tpu_torch.bench.gt import exact_ground_truth, id_recall
    import numpy as np

    from cuvs_tpu_torch import capi
    from cuvs_tpu_torch import io as cio
    from cuvs_tpu_torch import mg
    from cuvs_tpu_torch.bench.measure import timed_qps
    from cuvs_tpu_torch.cluster import kmeans, kmeans_balanced
    from cuvs_tpu_torch.core import bitpack
    from cuvs_tpu_torch.distance import pairwise
    from cuvs_tpu_torch.mg import snmg
    from cuvs_tpu_torch.neighbors import (all_neighbors, brute_force, cagra, composite,
                                          dynamic_batching, graph_core, hnsw, ivf_flat, ivf_pq,
                                          ivf_rabitq, ivf_sq, knn_graph, offload, refine, scann,
                                          tiered_index, vamana)
    from cuvs_tpu_torch.neighbors import ivf_scan as nb_ivf_scan
    from cuvs_tpu_torch.ops import _lib, bf_topk, ivf_scan
    from cuvs_tpu_torch.preprocessing import quantize
    from cuvs_tpu_torch.utils import serialize

    t_start = time.time()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    # the kernels (nvcc) and the port's C library (c++) build while the data is made
    build_s = {}

    def build(name, fn):
        t0 = time.time()
        fn()
        build_s[name] = time.time() - t0

    builders = [threading.Thread(target=build, args=("kernels", _lib.lib)),
                threading.Thread(target=build, args=("C library", capi.build))]
    for th in builders:
        th.start()
    t0 = time.time()
    ds = datasets.load("sift-128-euclidean", max_rows=N)
    # float32 rows, as the queries: the stand-in is float64 where numpy 2 runs (the reference's
    # generator, which the port's reproduces byte for byte)
    x = torch.from_numpy(ds.base).float().to(dev)
    q = torch.from_numpy(ds.queries[:NQ].astype("float32")).to(dev)
    n, dim = x.shape
    print(f"# dataset sift-128-euclidean{' (synthetic)' if ds.synthetic else ''}: "
          f"n={n} d={dim} nq={q.shape[0]} k={K} ({time.time() - t0:.1f} s)")
    for th in builders:
        th.join()
    _lib.lib()  # a build that failed in its thread is retried here, and raises
    capi.build()
    print(f"# build: {build_s.get('kernels', float('nan')):.1f} s (nvcc, sm_90a) -> "
          f"{_lib.library_path().name}; the port's C library "
          f"{build_s.get('C library', float('nan')):.1f} s (c++) -> {capi.library_path().name}")
    print("# nvcc seconds per source, all at once: " + ", ".join(
        f"{src} {sec:.1f}" for src, sec in sorted(_lib.NVCC_SECONDS.items(), key=lambda kv: -kv[1])))

    results, calls, counts = {}, {}, {}
    held0 = torch.cuda.memory_allocated(dev)  # the dataset and the queries
    for _, mod, *_ in kernels():
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0
    with recording(calls, counts) as tagged:
        # 1. exact ground truth (fused exact kernel, unfused cross-check)
        t0 = time.time()
        bf = brute_force.build(x, metric=ds.metric)
        gti = exact_ground_truth(bf, q, K)
        print(f"# ground truth: fused exact kernel, cross-check on 256 queries passed "
              f"({time.time() - t0:.1f} s)")

        def phase(label, fn, gt=None):
            gt = gti if gt is None else gt
            d, i = fn(q)
            torch.cuda.synchronize()
            check(d.shape == (q.shape[0], K) and i.shape == (q.shape[0], K), f"{label}: shape")
            check(bool(torch.isfinite(d).all()), f"{label}: non-finite distances")
            rec = id_recall(i.cpu(), gt)
            qps = timed_qps(fn, q, reps=5, min_time_s=1.0, max_reps=32)
            print(f"# {label}: recall@10={rec:.4f} qps={qps:.0f}")
            results[label] = dict(fn=fn, recall=rec, qps=qps, gt=gt, out=(d, i))

        # 2. exact fused brute force, f32 (the default fused search)
        phase("bf_fused_exact_f32", lambda qq: brute_force.search(bf, qq, K, fused=True))
        # 3. approximate fused brute force, bf16
        phase("bf_fused_bf16", lambda qq: brute_force.search(
            bf, qq, K, compute_dtype=torch.bfloat16, recall_target=0.97, fused=True))
        # 4. int8 fused brute force, alone and + refine
        bf8 = brute_force.build(x, metric=ds.metric, storage_dtype=torch.int8)
        int8_kw = dict(recall_target=0.97, fused=True)
        phase("bf_int8_fused", lambda qq: brute_force.search(bf8, qq, K, **int8_kw))
        phase("bf_int8_fused_refine", lambda qq: refine.refine(
            x, qq, brute_force.search(bf8, qq, CAND, **int8_kw)[1], K, metric=ds.metric))
        # 5. IVF-Flat, fused cluster-major scan
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

        def build_ivf(label, fn):
            t0 = time.time()
            index = fn()
            torch.cuda.synchronize()
            sz = index.lists.sizes.float()
            print(f"# {label} build: {index.n_lists} lists, sizes min/mean/max "
                  f"{int(sz.min())}/{float(sz.mean()):.0f}/{int(sz.max())}, window {index.window} "
                  f"({time.time() - t0:.1f} s)")
            return index

        # k = 100: the IVF-Flat scan's deep bins, on each tile
        cli_flat = build_ivf("ivf_flat f32 (the CLI's)", lambda: ivf_flat.build(
            x, n_lists=CLI_LISTS, metric=ds.metric, seed=0))
        f32q = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="fused")
        # (label, tag of the k = 10 search, tag of the k = 100 one, its variant, search(k))
        deep_flat = [
            (f"ivf_fused_p{N_PROBES}", None, f"-k{DEEP_K}", "bfloat16",
             lambda k: ivf_flat.search(idx, q, k, sp)),
            (f"ivf_fused_f32q_p{N_PROBES}", "-f32q", f"-f32q-k{DEEP_K}", "bfloat16",
             lambda k: ivf_flat.search(idx, q, k, f32q)),
            (f"ivf_fused_f32_p{CLI_PROBES}", f"-p{CLI_PROBES}", f"-k{DEEP_K}", "float32",
             lambda k: ivf_flat.search(cli_flat, q, k, n_probes=CLI_PROBES)),
        ]
        for label, tag10, tag100, rows, search in deep_flat:
            t0 = time.time()
            if tag10 is None:
                rec10 = results[label]["recall"]
            else:
                with tagged(tag10):
                    rec10 = id_recall(search(K)[1].cpu(), gti)
            with tagged(tag100):
                d100, i100 = search(DEEP_K)
            torch.cuda.synchronize()
            check(d100.shape == (q.shape[0], DEEP_K) and bool(torch.isfinite(d100).all()),
                  f"{label} k={DEEP_K}: shape or non-finite distances")
            rec100 = id_recall(i100[:, :K].cpu(), gti)
            var = rows + tag100
            attrs = scan_compare.scan_kernel_attributes(*calls[("ivf_scan", var)])
            print(f"# {label} k={DEEP_K} (cap {-(-DEEP_K // 32)}, variant {var}): recall@10 of "
                  f"its first {K} ids {rec100:.4f} (k={K}: {rec10:.4f}); kernel: depth class "
                  f"{attrs['depth']}, {attrs['slots']} slots x {attrs['parts']} part(s) a block, "
                  f"{attrs['registers']} registers, {attrs['local_bytes']} local bytes "
                  f"({time.time() - t0:.1f} s)")
            check(rec100 >= rec10 - RECALL_SLACK,
                  f"{label} k={DEEP_K}: first {K} ids' recall below k={K}'s")
            check(attrs["local_bytes"] == 0, f"{label} k={DEEP_K}: the kernel's bins spill")
            del d100, i100
        del cli_flat

        # 6. IVF-PQ, fused quantized-code scan (bf16 and int8 tables)
        pq = build_ivf("ivf_pq", lambda: ivf_pq.build(x, n_lists=Q_LISTS, pq_dim=64, pq_bits=8,
                                                      metric=ds.metric, seed=0))
        pq_sp = {lut: ivf_pq.SearchParams(n_probes=Q_PROBES, scan_algo="fused", lut_dtype=lut)
                 for lut in (torch.bfloat16, torch.int8)}
        phase(f"ivf_pq_fused_p{Q_PROBES}", lambda qq: ivf_pq.search(
            pq, qq, K, pq_sp[torch.bfloat16]))
        phase(f"ivf_pq_fused_p{Q_PROBES}_refine", lambda qq: refine.refine(
            x, qq, ivf_pq.search(pq, qq, CAND, pq_sp[torch.bfloat16])[1], K, metric=ds.metric))
        phase(f"ivf_pq_fused_int8lut_p{Q_PROBES}_refine", lambda qq: refine.refine(
            x, qq, ivf_pq.search(pq, qq, CAND, pq_sp[torch.int8])[1], K, metric=ds.metric))
        # k = 100: the kernel's deep bins (cap 4)
        t0 = time.time()
        with tagged(f"-k{DEEP_K}"):
            d100, i100 = ivf_pq.search(pq, q, DEEP_K, pq_sp[torch.bfloat16])
        torch.cuda.synchronize()
        check(d100.shape == (q.shape[0], DEEP_K) and bool(torch.isfinite(d100).all()),
              f"ivf_pq k={DEEP_K}: shape or non-finite distances")
        rec100 = id_recall(i100[:, :K].cpu(), gti)
        rec10 = results[f"ivf_pq_fused_p{Q_PROBES}"]["recall"]
        print(f"# ivf_pq_fused_p{Q_PROBES} k={DEEP_K} (cap {-(-DEEP_K // 32)}): recall@10 of its "
              f"first {K} ids {rec100:.4f} (k={K}: {rec10:.4f}; {time.time() - t0:.1f} s)")
        check(rec100 >= rec10 - RECALL_SLACK,
              f"ivf_pq k={DEEP_K}: first {K} ids' recall below k={K}'s")
        del d100, i100
        # the kernel's other code widths: IVF-PQ at 4 and 5 bits (byte codes, books of 16 and 32)
        pq_bits = {b: build_ivf(f"ivf_pq {b}-bit", lambda b=b: ivf_pq.build(
            x, n_lists=Q_LISTS, pq_dim=64, pq_bits=b, metric=ds.metric, seed=0)) for b in (4, 5)}
        for b, index in pq_bits.items():
            phase(f"ivf_pq{b}_fused_p{Q_PROBES}", lambda qq, ix=index: ivf_pq.search(
                ix, qq, K, pq_sp[torch.bfloat16]))
        phase(f"ivf_pq4_fused_int8lut_p{Q_PROBES}", lambda qq: ivf_pq.search(
            pq_bits[4], qq, K, pq_sp[torch.int8]))
        with tagged(f"-k{DEEP_K}"):
            d100, i100 = ivf_pq.search(pq_bits[4], q, DEEP_K, pq_sp[torch.bfloat16])
        torch.cuda.synchronize()
        check(d100.shape == (q.shape[0], DEEP_K) and bool(torch.isfinite(d100).all()),
              f"ivf_pq 4-bit k={DEEP_K}: shape or non-finite distances")
        rec100 = id_recall(i100[:, :K].cpu(), gti)
        rec4 = results[f"ivf_pq4_fused_p{Q_PROBES}"]["recall"]
        check(rec100 >= rec4 - RECALL_SLACK,
              f"ivf_pq 4-bit k={DEEP_K}: first {K} ids' recall below k={K}'s")
        del d100, i100
        for var in ("pq-bf16-4bit", "pq-bf16-5bit", "pq-int8lut-4bit", f"pq-bf16-4bit-k{DEEP_K}"):
            attrs = scan_compare.pq_kernel_attributes(*calls[("pq_scan", var)])
            print(f"# pq_scan [{var}]: {attrs['source']}, depth class {attrs['depth']}, "
                  f"{attrs['slots']} slots a block, {attrs['blocks_per_sm']} blocks an SM, "
                  f"{attrs['registers']} registers, {attrs['local_bytes']} local bytes")
            check(attrs["family"] == 3 and attrs["local_bytes"] == 0,
                  f"pq_scan [{var}] ran family {attrs['family']} with {attrs['local_bytes']} "
                  f"local bytes: not the byte-code widths' instantiation, or it spills")
        print(f"# ivf_pq p{Q_PROBES} recall@10 by pq_bits: 8 {rec10:.4f}, 5 "
              f"{results[f'ivf_pq5_fused_p{Q_PROBES}']['recall']:.4f}, 4 {rec4:.4f} (int8 table "
              f"{results[f'ivf_pq4_fused_int8lut_p{Q_PROBES}']['recall']:.4f}; k={DEEP_K}'s first "
              f"{K} ids {rec100:.4f})")
        # 7. IVF-RaBitQ, 3 bits: the same kernel's rabitq epilogue
        rq = build_ivf("ivf_rabitq", lambda: ivf_rabitq.build(
            x, n_lists=Q_LISTS, bits_per_dim=3, metric=ds.metric, seed=0))
        rq_sp = ivf_rabitq.SearchParams(n_probes=Q_PROBES, scan_algo="fused")
        phase(f"ivf_rabitq_b3_p{Q_PROBES}", lambda qq: ivf_rabitq.search(rq, qq, K, rq_sp))
        phase(f"ivf_rabitq_b3_p{Q_PROBES}_refine", lambda qq: refine.refine(
            x, qq, ivf_rabitq.search(rq, qq, CAND, rq_sp)[1], K, metric=ds.metric))

        def with_refine(label, search):
            phase(label, lambda qq: search(qq, K))
            phase(f"{label}_refine", lambda qq: refine.refine(x, qq, search(qq, CAND)[1], K,
                                                              metric=ds.metric))

        # 8. the phase-5 index through the unfused cluster-major scan
        cm_sp = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="cluster_major",
                                      compute_dtype=torch.bfloat16)
        phase(f"ivf_cluster_major_p{N_PROBES}", lambda qq: ivf_flat.search(idx, qq, K, cm_sp))
        check(results[f"ivf_cluster_major_p{N_PROBES}"]["recall"]
              >= results[f"ivf_fused_p{N_PROBES}"]["recall"] - RECALL_SLACK,
              "cluster-major recall below the fused scan's")
        # ... and with a broadcasting metric UDF: its chunks bound the [.., d] blocks
        udf_sp = ivf_flat.SearchParams(n_probes=N_PROBES, metric_udf=lambda a, b: (
            (a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        phase(f"ivf_udf_auto_p{N_PROBES}", lambda qq: ivf_flat.search(idx, qq, K, udf_sp))
        udf_mem = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
        print(f"# ivf_udf_auto_p{N_PROBES}: {udf_mem:.2f} GiB above the {held / 2**30:.2f} GiB "
              "held")
        check(udf_mem <= 4.0, "metric UDF search took more than 4 GiB of device memory")
        check(results[f"ivf_udf_auto_p{N_PROBES}"]["recall"]
              >= results[f"ivf_cluster_major_p{N_PROBES}"]["recall"] - RECALL_SLACK,
              "metric UDF recall below the cluster-major scan's")
        # 9. IVF-Flat cosine: auto routes cosine to the cluster-major scan
        t0 = time.time()
        gti_cos = brute_force.search(brute_force.build(x, metric="cosine"), q, K)[1].cpu().numpy()
        print(f"# cosine ground truth: unfused brute force ({time.time() - t0:.1f} s)")
        ivc = build_ivf("ivf_flat_cosine", lambda: ivf_flat.build(
            x, n_lists=N_LISTS, metric="cosine", seed=0))
        phase(f"ivf_cosine_auto_p{N_PROBES}",
              lambda qq: ivf_flat.search(ivc, qq, K, n_probes=N_PROBES), gt=gti_cos)
        check(results[f"ivf_cosine_auto_p{N_PROBES}"]["recall"] >= 0.86,
              "cosine recall below 0.86")
        # 10. build on the first 900k rows, extend by the last 100k
        ive = build_ivf("ivf_flat_extend", lambda: ivf_flat.extend(ivf_flat.build(
            x[:N_FIRST], n_lists=N_LISTS, metric=ds.metric, seed=0,
            storage_dtype=torch.bfloat16), x[N_FIRST:]))
        check(ive.n_rows == n, "extended IVF-Flat: n_rows")
        phase(f"ivf_extend_fused_p{N_PROBES}", lambda qq: ivf_flat.search(ive, qq, K, sp))
        check(results[f"ivf_extend_fused_p{N_PROBES}"]["recall"]
              >= results[f"ivf_fused_p{N_PROBES}"]["recall"] - 0.01,
              "extended IVF-Flat recall more than 0.01 below the built one's")
        # 11. streaming int8 build from host slices (the int8 ivf_scan variant)
        base = ds.base
        slices = lambda i: base[i * SLICE:(i + 1) * SLICE]  # noqa: E731
        ivs = build_ivf("ivf_flat_streaming", lambda: ivf_flat.build_streaming(
            slices, n // SLICE, n_lists=N_LISTS, metric=ds.metric, seed=0))
        check(ivs.sorted_data.dtype == torch.int8, "streamed IVF-Flat is not int8")
        fused8 = ivf_flat.SearchParams(n_probes=N_PROBES, scan_algo="fused")
        with_refine(f"ivf_stream_int8_p{N_PROBES}",
                    lambda qq, kk: ivf_flat.search(ivs, qq, kk, fused8))
        # 12. IVF-PQ, per-cluster codebooks, unfused cluster-major scan
        pqc = build_ivf("ivf_pq_per_cluster", lambda: ivf_pq.build(
            x, n_lists=Q_LISTS, pq_dim=64, pq_bits=8, metric=ds.metric, seed=0,
            codebook_gen="per_cluster"))
        pq_cm = ivf_pq.SearchParams(n_probes=Q_PROBES, scan_algo="cluster_major")
        with_refine(f"ivf_pq_per_cluster_cm_p{Q_PROBES}",
                    lambda qq, kk: ivf_pq.search(pqc, qq, kk, pq_cm))
        for suffix in ("", "_refine"):
            check(results[f"ivf_pq_per_cluster_cm_p{Q_PROBES}{suffix}"]["recall"]
                  >= results[f"ivf_pq_fused_p{Q_PROBES}{suffix}"]["recall"] - 0.01,
                  f"per-cluster IVF-PQ{suffix} recall more than 0.01 below phase 6's")
        # 13. IVF-PQ built on 900k rows, extended by 100k
        pqe = build_ivf("ivf_pq_extend", lambda: ivf_pq.extend(ivf_pq.build(
            x[:N_FIRST], n_lists=Q_LISTS, pq_dim=64, pq_bits=8, metric=ds.metric, seed=0),
            x[N_FIRST:]))
        check(pqe.n_rows == n, "extended IVF-PQ: n_rows")
        with_refine(f"ivf_pq_extend_fused_p{Q_PROBES}",
                    lambda qq, kk: ivf_pq.search(pqe, qq, kk, pq_sp[torch.bfloat16]))
        # 14. IVF-PQ streaming build from host slices
        pqs = build_ivf("ivf_pq_streaming", lambda: ivf_pq.build_streaming(
            slices, n // SLICE, n_lists=Q_LISTS, pq_dim=64, pq_bits=8, metric=ds.metric,
            seed=0))
        codes = bitpack.unpack(pqs.sorted_codes[:pqs.n_rows], pqs.pq_bits, pqs.pq_dim)
        check(torch.equal(pqs.sorted_codes_t,
                          nb_ivf_scan.pack_codes_transposed(codes, pqs.window)),
              "streamed IVF-PQ serving layout differs from pack_codes_transposed")
        del codes
        with_refine(f"ivf_pq_stream_fused_p{Q_PROBES}",
                    lambda qq, kk: ivf_pq.search(pqs, qq, kk, pq_sp[torch.bfloat16]))
        # 15. refine_host from the host base on phase 14's candidates
        cand = ivf_pq.search(pqs, q, CAND, pq_sp[torch.bfloat16])[1]
        hd, hi = refine.refine_host(base, q, cand, K, metric=ds.metric)
        rd, ri = refine.refine(x, q, cand, K, metric=ds.metric)
        check_same_ranking(hd, hi, rd, ri, "refine_host against refine")
        print("# refine_host on the streamed IVF-PQ's candidates equals refine on the card")
        phase(f"ivf_pq_stream_fused_p{Q_PROBES}_refine_host", lambda qq: refine.refine_host(
            base, qq, ivf_pq.search(pqs, qq, CAND, pq_sp[torch.bfloat16])[1], K,
            metric=ds.metric))
        # 16. IVF-SQ
        sq = build_ivf("ivf_sq", lambda: ivf_sq.build(x, n_lists=Q_LISTS, metric=ds.metric,
                                                      seed=0))
        sq_sp = ivf_sq.SearchParams(n_probes=Q_PROBES)
        with_refine(f"ivf_sq_p{Q_PROBES}", lambda qq, kk: ivf_sq.search(sq, qq, kk, sq_sp))
        check(results[f"ivf_sq_p{Q_PROBES}_refine"]["recall"]
              >= results[f"ivf_pq_fused_p{Q_PROBES}_refine"]["recall"] - 0.01,
              "IVF-SQ + refine recall more than 0.01 below IVF-PQ + refine's")
        # 17. save and load the phase-6 IVF-PQ and phase-11 IVF-Flat indexes
        with tempfile.TemporaryDirectory() as tmp:
            for label, index, search in (
                    (f"ivf_pq_loaded_fused_p{Q_PROBES}", pq,
                     lambda ix, qq: ivf_pq.search(ix, qq, K, pq_sp[torch.bfloat16])),
                    (f"ivf_stream_int8_loaded_p{N_PROBES}", ivs,
                     lambda ix, qq: ivf_flat.search(ix, qq, K, fused8))):
                t0 = time.time()
                path = os.path.join(tmp, "index.npz")
                serialize.save(path, index)
                loaded = serialize.load(path)
                torch.cuda.synchronize()
                print(f"# {label}: save + load {os.path.getsize(path) / 2**20:.0f} MiB "
                      f"({time.time() - t0:.1f} s)")
                (a, b), (c, e) = search(index, q), search(loaded, q)
                check(torch.equal(a, c) and torch.equal(b, e),
                      f"{label}: search differs after save and load")
                phase(label, lambda qq, _ix=loaded, _s=search: _s(_ix, qq))

        peaks = [peak_before]

        def phase_peak(label):
            """Print the device-memory peak since the last reset, then reset."""
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
            print(f"# {label}: peak device memory {peaks[-1] / 2**30:.2f} GiB "
                  f"({held_at[0] / 2**30:.2f} GiB held before it)")
            held_at[0] = torch.cuda.memory_allocated(dev)

        held_at = [held0]
        phase_peak("phases 1-17")
        cg_res = {}

        def cagra_phase(label, fn, gt=None):
            phase(label, fn, gt)
            cg_res[label] = results.pop(label)  # held to the loop through the beam kernel's calls

        # 18. CAGRA build as bench.py:307-319 builds it: partitioned knn graph + optimize
        split = {}
        t0 = time.time()
        with timed_calls([(knn_graph, "build_knn_graph"), (graph_core, "optimize"),
                          (graph_core, "_detour_counts"), (all_neighbors, "_partition")], split):
            cg = cagra.build(x, intermediate_graph_degree=128, graph_degree=64, build_algo="auto",
                             metric=ds.metric, build_compute_dtype=torch.bfloat16,
                             build_recall_target=0.97, seed=0)
        torch.cuda.synchronize()
        print(f"# cagra build 128 -> 64: {time.time() - t0:.1f} s (knn graph, partitioned: "
              f"{split['build_knn_graph'][0]:.1f} s; optimize: {split['optimize'][0]:.1f} s, of "
              f"which detour counts {split['_detour_counts'][0]:.1f} s)")
        check(cg.graph.shape == (n, 64) and cg.graph.dtype == torch.int32, "cagra graph shape")
        check_graph(cg.graph, n, "cagra graph")
        knn128 = split["build_knn_graph"][1][0]
        check_graph(knn128, n, "cagra knn graph")
        # exact neighbours of 1024 sampled rows (unfused: k = 129 > the exact kernel's 64)
        gen = torch.Generator().manual_seed(0)
        rows = torch.randperm(n, generator=gen)[:1024].to(dev)
        ex = without_self(brute_force.search(bf, x[rows], 129)[1], rows, 128).cpu()
        # what bounds it: exact neighbours outside both of a row's clusters, bf16 operands
        assign = split["_partition"][1]  # [n, 2] clusters of each row (host)
        a_row, a_ex = assign[rows.cpu().numpy()], assign[ex.numpy()]
        reach = (a_ex[:, :, :, None] == a_row[:, None, None, :]).any((2, 3)).mean()
        exb = without_self(brute_force.search(bf, x[rows], 129, compute_dtype=torch.bfloat16)[1],
                           rows, 128).cpu()
        print(f"# cagra partitioned knn graph recall@128 on 1024 sampled rows: "
              f"{id_recall(knn128[rows].cpu(), ex):.4f}; exact neighbours within the row's "
              f"{assign.shape[1]} of {int(assign.max()) + 1} clusters {reach:.4f}; bf16 operands "
              f"over all rows {id_recall(exb, ex):.4f}")
        phase_peak("cagra build")
        build_peak18 = peaks[-1]
        # 19. CAGRA search as bench.py:340-367 searches it
        cg_sp = {it: cagra.SearchParams(itopk_size=it, search_width=2,
                                        compute_dtype=torch.bfloat16, query_chunk=NQ)
                 for it in (64, 128, 192)}
        for it in (64, 128):
            cagra_phase(f"cagra_itopk{it}", lambda qq, _sp=cg_sp[it]: cagra.search(cg, qq, K, _sp))
        check(cg_res["cagra_itopk128"]["recall"] >= cg_res["cagra_itopk64"]["recall"] - RECALL_SLACK,
              "cagra: itopk 128 recall more than 0.005 below itopk 64's")
        # the benchmark cell's beam search: one chunk of 10,000 queries (each copy of the
        # 4096 draws its own seeds), itopk 128, width 1, f32; one kernel launch a chunk
        q_cell = q.repeat(-(-CELL_NQ // NQ), 1)[:CELL_NQ]
        cell_sp = cagra.SearchParams(itopk_size=128, query_chunk=CELL_NQ)
        cagra.search(cg, q_cell, K, cell_sp)  # warm-up
        beams = launch_counts()["cagra_beam"]
        torch.cuda.synchronize()
        t0 = time.time()
        _, i_cell = cagra.search(cg, q_cell, K, cell_sp)
        torch.cuda.synchronize()
        secs = time.time() - t0
        check(launch_counts()["cagra_beam"] == beams + 1,
              "cagra: the 10,000-query chunk did not launch the beam kernel once")
        beams = launch_counts()["cagra_beam"]
        cagra.search(cg, q, K, cagra.SearchParams(itopk_size=64, search_width=2,
                                                  compute_dtype=torch.bfloat16, query_chunk=1000))
        check(launch_counts()["cagra_beam"] == beams + -(-NQ // 1000),
              "cagra: not one beam kernel launch a chunk of 1000 queries")
        print(f"# cagra beam search in the benchmark cell's shape ({CELL_NQ} queries in one "
              f"chunk, itopk 128, width 1, f32): {secs * 1e3:.1f} ms, {CELL_NQ / secs:.0f} QPS, "
              f"recall@10 of the first {NQ} {id_recall(i_cell[:NQ].cpu(), gti):.4f}; one "
              f"launch a chunk")
        for it in (64, 128, 192):  # bench.py's ladder, until refined recall@10 >= 0.95
            label = f"cagra_itopk{it}_refine"
            cagra_phase(label, lambda qq, _sp=cg_sp[it]: refine.refine(
                x, qq, cagra.search(cg, qq, CAND, _sp)[1], K, metric=ds.metric))
            if it in (64, 128):
                check(cg_res[label]["recall"] >= cg_res[f"cagra_itopk{it}"]["recall"],
                      f"{label}: recall below the unrefined search's")
            if cg_res[label]["recall"] >= 0.95:
                print(f"# cagra + refine reaches recall@10 >= 0.95 at itopk {it}")
                break
        else:
            raise SmokeFailure("cagra + refine below recall@10 0.95 at itopk 64, 128 and 192")
        cg_cpu = cagra.Index(dataset=cg.dataset.cpu(), dataset_norms=cg.dataset_norms.cpu(),
                             graph=cg.graph.cpu(), metric=cg.metric)
        t0 = time.time()
        _, i_card = cagra.search(cg, q[:256], K, cg_sp[64])
        _, i_host = cagra.search(cg_cpu, q[:256].cpu(), K, cg_sp[64])
        same = float((i_card.cpu() == i_host).float().mean())
        print(f"# cagra itopk 64 on the card and on a CPU copy, 256 queries, the same seeds: "
              f"{same:.4f} of (query, rank) ids equal ({time.time() - t0:.1f} s)")
        check(same >= 0.99, "cagra: the card's ids differ from the CPU's at more than 1%")
        del cg_cpu
        # control for phase 20's degree: phase 18's knn graph pruned to 32, itopk 64
        cg32 = cagra.from_graph(x, graph_core.optimize(knn128, 32), metric=ds.metric)
        cagra_phase("cagra_128to32_itopk64", lambda qq: cagra.search(cg32, qq, K, cg_sp[64]))
        del cg32, knn128, split
        phase_peak("cagra search")
        # 20. CAGRA through IVF-PQ + refine, cagra.yaml base 96 -> 64
        split20, events20 = {}, {}
        launches_before = launch_counts()
        t0 = time.time()
        with tagged("-cagra-build"), timed_calls([(knn_graph, "build_knn_graph"),
                                                  (graph_core, "optimize")], split20), \
                scan_compare.phase_events(events20, {**scan_compare.PHASES,
                                                     "refine": [(refine, "refine")]}):
            cg2 = cagra.build(x, intermediate_graph_degree=96, graph_degree=64, build_algo="ivf_pq",
                              metric=ds.metric, seed=0)
        torch.cuda.synchronize()
        pq_builds = ivf_scan.LAUNCHES["pq_scan"] - launches_before["pq_scan"]
        merges = launch_counts()["pool_topk"] - launches_before["pool_topk"]
        print(f"# cagra build ivf_pq 96 -> 64: {time.time() - t0:.1f} s (knn graph: "
              f"{split20['build_knn_graph'][0]:.1f} s, {pq_builds} pq_scan launches, {merges} "
              f"pool_topk launches; optimize: {split20['optimize'][0]:.1f} s)")
        n_batches = -(-n // NQ)
        per_batch = {ph: sum(a.elapsed_time(b) for a, b in ev) / n_batches
                     for ph, ev in events20.items()}
        knn_ms = split20["build_knn_graph"][0] * 1e3 / n_batches
        per_batch["rest"] = knn_ms - sum(per_batch.values())
        print(f"# cagra ivf_pq knn graph, ms per {NQ}-row batch ({n_batches} batches): "
              + ", ".join(f"{ph} {ms:.2f}" for ph, ms in per_batch.items()) + f" ({smi})")
        check(pq_builds >= -(-n // NQ), "cagra ivf_pq build: fewer pq_scan launches than batches")
        check(merges >= -(-n // NQ), "cagra ivf_pq build: fewer pool_topk launches than batches")
        check_graph(cg2.graph, n, "cagra ivf_pq graph")
        knn96 = split20["build_knn_graph"][1][0]
        knn_rec = id_recall(knn96[rows].cpu(), ex[:, :96])  # phase 18's rows and neighbours
        print(f"# cagra ivf_pq knn graph recall@96 on 1024 sampled rows: {knn_rec:.4f}")
        cagra_phase("cagra_ivfpq_itopk64", lambda qq: cagra.search(cg2, qq, K, cg_sp[64]))
        cagra_phase("cagra_ivfpq_itopk64_refine", lambda qq: refine.refine(
            x, qq, cagra.search(cg2, qq, CAND, cg_sp[64])[1], K, metric=ds.metric))
        check(cg_res["cagra_ivfpq_itopk64"]["recall"] >= cg_res["cagra_itopk64"]["recall"] - 0.10,
              "cagra ivf_pq: recall more than 0.10 below phase 19's itopk 64")
        check(cg_res["cagra_ivfpq_itopk64_refine"]["recall"]
              >= cg_res["cagra_ivfpq_itopk64"]["recall"], "cagra ivf_pq + refine below unrefined")
        del cg2, knn96, split20
        phase_peak("cagra ivf_pq build and search")
        # 21. long-tail brute force, held against torch.cdist + torch.topk (a check only)
        qs = q[:256]
        for metric, p_norm in (("l1", 1.0), ("chebyshev", float("inf"))):
            bfm = brute_force.build(x, metric=metric)
            ms, (d, i) = cuda_ms(lambda: brute_force.search(bfm, qs, K))
            lib_ms, (ld, li) = cuda_ms(lambda: torch.topk(torch.cdist(qs, x, p=p_norm), K,
                                                          largest=False))
            check_same_ranking(d, i, ld, li, f"brute force {metric} against torch.cdist")
            print(f"# brute force {metric}, 256 queries x {n}: {ms:.1f} ms per batch (cdist + topk "
                  f"{lib_ms:.1f} ms); ids equal except at ties")
            del bfm
        gen = torch.Generator().manual_seed(1)
        used = {}  # the largest share of the tolerance atol + rtol * |cpu| used, per metric
        for metric in pairwise.DistanceType:
            if metric == pairwise.DistanceType.Precomputed:
                continue
            a, b = pairwise_inputs(metric, gen, 512, 128)
            card = pairwise.pairwise_distance(a.to(dev), b.to(dev), metric=metric, p=3.0).cpu()
            host = pairwise.pairwise_distance(a, b, metric=metric, p=3.0)
            used[metric.name] = float(((card - host).abs() / (1e-5 + 1e-5 * host.abs())).max())
            check(used[metric.name] <= 1.0,
                  f"pairwise_distance {metric.name}: the card differs from the CPU")
        top = sorted(used.items(), key=lambda kv: -kv[1])[:3]
        print("# pairwise_distance, every metric, 512 x 512 x 128: the card matches the CPU "
              "(rtol 1e-5, atol 1e-5; largest shares of the tolerance: "
              + ", ".join(f"{m} {u:.3f}" for m, u in top) + ")")
        phase_peak("long-tail brute force")
        # 22. packed CAGRA: phase 18's index, the child array in pieces of at most 2 GiB
        t0 = time.time()
        pk = cagra.pack(cg)
        torch.cuda.synchronize()
        child_bytes = sum(cv.numel() for cv in pk.child_vecs)
        print(f"# cagra pack 128 -> 64 graph: {time.time() - t0:.2f} s, {len(pk.child_vecs)} pieces "
              f"of {pk.child_vecs[0].shape[1]} neighbours, child array {child_bytes / 2**30:.2f} GiB")
        check(len(pk.child_vecs) == 4, "packed CAGRA: not 4 pieces at the default 2 GiB")
        for it in (64, 128):
            cagra_phase(f"cagra_packed_itopk{it}",
                        lambda qq, _sp=cg_sp[it]: cagra.search(pk, qq, K, _sp))
            check(cg_res[f"cagra_packed_itopk{it}"]["recall"]
                  >= cg_res[f"cagra_itopk{it}"]["recall"] - 0.05,
                  f"packed CAGRA itopk {it}: recall more than 0.05 below phase 19's")
            print(f"# cagra itopk {it}: packed {cg_res[f'cagra_packed_itopk{it}']['qps']:.0f} QPS "
                  f"against the standard layout's {cg_res[f'cagra_itopk{it}']['qps']:.0f}")
        cagra_phase("cagra_packed_itopk128_refine", lambda qq: refine.refine(
            x, qq, cagra.search(pk, qq, CAND, cg_sp[128])[1], K, metric=ds.metric))
        # distances against exact f32 ones (tests/test_cagra.py:228), in f32 compute; the int8
        # rounding's own error: the packed formula |q|^2 + |x|^2 - 2 q.(x8 scale) in float64
        d_pk, i_pk = cagra.search(pk, q, K, itopk_size=64, search_width=2, query_chunk=NQ)
        rows_pk = i_pk.long()
        true = ((q[:, None, :].double() - x[rows_pk].double()) ** 2).sum(-1)
        x8 = pk.dataset_int8[rows_pk].double() * pk.scale.double()
        packed = ((q.double() ** 2).sum(1)[:, None] + pk.dataset_norms[rows_pk].double()
                  - 2.0 * (q[:, None, :].double() * x8).sum(-1))
        rel = lambda d: float(((d.double() - true).abs() / true.clamp_min(1e-6)).median())  # noqa
        rel_search, rel_round = rel(d_pk), rel(packed)
        bound = 0.02 if rel_round <= 0.02 else rel_round * 1.01
        print(f"# cagra packed: median relative distance error {rel_search:.5f} (the int8 rounding "
              f"alone {rel_round:.5f}; held to {bound:.5f})")
        check(rel_search < bound, "packed CAGRA: distances too far from the exact ones")
        i_four = cagra.search(pk, q, K, cg_sp[64])[1]
        del pk, d_pk, i_pk, rows_pk, true, x8, packed
        pk1 = cagra.pack(cg, _piece_bytes=1 << 40)
        check(len(pk1.child_vecs) == 1, "packed CAGRA: not one piece")
        check(torch.equal(cagra.search(pk1, q, K, cg_sp[64])[1], i_four),
              "packed CAGRA: one piece returns other ids than four")
        cagra_phase("cagra_packed_one_piece_itopk64", lambda qq: cagra.search(pk1, qq, K, cg_sp[64]))
        print(f"# cagra packed itopk 64: one piece {cg_res['cagra_packed_one_piece_itopk64']['qps']:.0f}"
              f" QPS against four pieces' {cg_res['cagra_packed_itopk64']['qps']:.0f}; ids equal")
        del pk1, i_four
        phase_peak("packed cagra")
        # 23. VPQ-compressed CAGRA: phase 18's index, 256 coarse centres, pq_dim 32 of 8 bits
        t0 = time.time()
        cgc = cagra.compress(cg, vq_n_centers=256, pq_dim=dim // 4, pq_bits=8, seed=0)
        torch.cuda.synchronize()
        code_bytes = cgc.vq_codes.numel() * 4 + cgc.pq_codes.numel()
        raw_bytes = cg.dataset.numel() * cg.dataset.element_size()
        print(f"# cagra compress: {time.time() - t0:.1f} s, codes {code_bytes / 2**20:.0f} MiB "
              f"against raw rows {raw_bytes / 2**20:.0f} MiB")
        cagra_phase("cagra_vpq_itopk128", lambda qq: cagra.search(cgc, qq, K, cg_sp[128]))
        cagra_phase("cagra_vpq_itopk128_refine", lambda qq: refine.refine(
            x, qq, cagra.search(cgc, qq, CAND, cg_sp[128])[1], K, metric=ds.metric))
        print(f"# cagra vpq itopk 128: recall {cg_res['cagra_vpq_itopk128']['recall']:.4f} (the "
              f"reference test's floor at its size 0.70; none here), + refine "
              f"{cg_res['cagra_vpq_itopk128_refine']['recall']:.4f} (floor 0.85)")
        check(cg_res["cagra_vpq_itopk128_refine"]["recall"] >= 0.85,
              "VPQ CAGRA + refine below recall 0.85")
        phase_peak("vpq cagra")
        # 24. composite of two exact brute-force halves (the exact kernel, twice a batch), its
        # calls recorded apart; then CAGRA's logical merge of two halves
        half = n // 2
        d2, i2 = results["bf_fused_exact_f32"]["out"]
        with tagged("-composite"):
            comp = composite.merge(brute_force, [brute_force.build(x[:half], metric=ds.metric),
                                                 brute_force.build(x[half:], metric=ds.metric)],
                                   strategy="logical")
            before = bf_topk.LAUNCHES["bf_topk_exact"]
            cd, ci = comp.search(q, K, fused=True)
            torch.cuda.synchronize()
            check(bf_topk.LAUNCHES["bf_topk_exact"] - before >= 2,
                  "composite: fewer exact-kernel launches than children")
            check_same_ranking(cd, ci, d2, i2, "composite of two halves against phase 2")
            phase("composite_bf_exact_f32", lambda qq: comp.search(qq, K, fused=True))
        print("# composite of two brute-force halves: ids equal phase 2's but at ties")
        del cd, ci
        gt_part = brute_force.search(brute_force.build(x[:PART_ROWS], metric=ds.metric), q,
                                     K)[1].cpu().numpy()
        t0 = time.time()
        halves = [cagra.build(part, intermediate_graph_degree=64, graph_degree=32,
                              build_algo="auto", metric=ds.metric, seed=0)
                  for part in (x[:PART_ROWS // 2], x[PART_ROWS // 2:PART_ROWS])]
        cm = cagra.merge(halves, strategy="logical")
        torch.cuda.synchronize()
        print(f"# cagra halves of the first {PART_ROWS} rows 64 -> 32, built and merged: "
              f"{time.time() - t0:.1f} s")
        cagra_phase(f"cagra_merged_logical_{PART_ROWS // 1000}k_itopk64",
                    lambda qq: cm.search(qq, K, params=cg_sp[64]), gt=gt_part)
        del halves, cm
        phase_peak("composite and merge")
        # 25. ACE on the first PART_ROWS rows: 4 partitions, overlap 2, 64 -> 32, the graph
        # spilled to a .npy memmap
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            ace = cagra.build_ace(x[:PART_ROWS], cagra.AceParams(build_dir=tmp))
            torch.cuda.synchronize()
            spilled = os.path.getsize(os.path.join(tmp, "ace_graph.npy"))
        print(f"# cagra build_ace {PART_ROWS} rows, 4 partitions 64 -> 32: "
              f"{time.time() - t0:.1f} s, graph file {spilled / 2**20:.0f} MiB")
        check(ace.graph.shape == (PART_ROWS, 32), "ace graph shape")
        check_graph(ace.graph, PART_ROWS, "ace graph")
        phase_peak("cagra build_ace")
        print(f"# cagra build_ace peak {peaks[-1] / 2**30:.2f} GiB ({PART_ROWS} rows) against "
              f"phase 18's build {build_peak18 / 2**30:.2f} GiB ({n} rows)")
        cagra_phase(f"cagra_ace_{PART_ROWS // 1000}k_itopk64",
                    lambda qq: cagra.search(ace, qq, K, cg_sp[64]), gt=gt_part)
        del ace
        # 26. iterative build on the first ITER_ROWS rows (3 rounds of self-search)
        xs = x[:ITER_ROWS]
        gt_sub = brute_force.search(brute_force.build(xs, metric=ds.metric), q, K)[1].cpu().numpy()
        t0 = time.time()
        itx = cagra.build_iterative(xs, graph_degree=32, intermediate_graph_degree=64, n_rounds=3)
        torch.cuda.synchronize()
        print(f"# cagra build_iterative {ITER_ROWS} rows 64 -> 32, 3 rounds: "
              f"{time.time() - t0:.1f} s")
        cagra_phase(f"cagra_iterative_{ITER_ROWS // 1000}k_itopk128",
                    lambda qq: cagra.search(itx, qq, K, cg_sp[128]), gt=gt_sub)
        check(cg_res[f"cagra_iterative_{ITER_ROWS // 1000}k_itopk128"]["recall"] >= 0.50,
              "iterative CAGRA below recall 0.50")
        pkx = cagra.pack(itx)
        pkx_cpu = cagra.PackedIndex(
            graph=pkx.graph.cpu(), child_vecs=tuple(cv.cpu() for cv in pkx.child_vecs),
            child_norms=pkx.child_norms.cpu(), dataset_int8=pkx.dataset_int8.cpu(),
            dataset_norms=pkx.dataset_norms.cpu(), scale=pkx.scale.cpu(), metric=pkx.metric)
        _, i_card = cagra.search(pkx, q[:256], K, cg_sp[64])
        _, i_host = cagra.search(pkx_cpu, q[:256].cpu(), K, cg_sp[64])
        same = float((i_card.cpu() == i_host).float().mean())
        print(f"# packed iterative CAGRA on the card and on a CPU copy, 256 queries, the same "
              f"seeds: {same:.4f} of (query, rank) ids equal")
        check(same >= 0.99, "packed CAGRA: the card's ids differ from the CPU's at more than 1%")
        del pkx_cpu
        with tempfile.TemporaryDirectory() as tmp:
            for label, index in (("packed iterative", pkx), ("vpq", cgc)):
                t0 = time.time()
                path = os.path.join(tmp, "index.npz")
                serialize.save(path, index)
                loaded = serialize.load(path)
                (a, b), (c, e) = (cagra.search(ix, q, K, cg_sp[64]) for ix in (index, loaded))
                check(torch.equal(a, c) and torch.equal(b, e),
                      f"cagra {label}: search differs after save and load")
                print(f"# cagra {label}: save + load {os.path.getsize(path) / 2**20:.0f} MiB, "
                      f"searches bit-identical ({time.time() - t0:.1f} s)")
                del loaded
        del itx, pkx, cgc, xs
        phase_peak("iterative cagra")
        # 27. Vamana at its defaults (R 32, L 64, alpha 1.2)
        prunes = {}
        t0 = time.time()
        with timed_calls([(vamana, "_robust_prune")], prunes):
            vm = vamana.build(x[:VAMANA_ROWS], metric=ds.metric)
        torch.cuda.synchronize()
        print(f"# vamana build {VAMANA_ROWS} rows R 32 L 64: {time.time() - t0:.1f} s "
              f"(robust prune {prunes['_robust_prune'][0]:.1f} s), {prunes['_robust_prune'][2]} "
              "insert rounds")
        g = vm.graph
        check(bool(((g >= -1) & (g < VAMANA_ROWS)).all()), "vamana graph: ids outside [0, n) or -1")
        check(not bool((g == torch.arange(VAMANA_ROWS, device=dev)[:, None]).any()),
              "vamana graph: self edges")
        gt_v = brute_force.search(brute_force.build(x[:VAMANA_ROWS], metric=ds.metric), q,
                                  K)[1].cpu().numpy()
        cagra_phase("vamana_itopk64", lambda qq: vamana.search(vm, qq, K, params=cg_sp[64]),
                    gt=gt_v)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "vamana.diskann")
            t0 = time.time()
            vamana.serialize(vm, path)
            back = vamana.deserialize(path, x[:VAMANA_ROWS], metric=ds.metric)
            check(back.medoid == vm.medoid and torch.equal(back.graph, vm.graph),
                  "vamana: graph or medoid differs after serialize and deserialize")
            print(f"# vamana DiskANN file {os.path.getsize(path) / 2**20:.0f} MiB: serialize + "
                  f"deserialize {time.time() - t0:.1f} s, graph and medoid equal")
        del vm, back, g
        phase_peak("vamana")
        # 28. HNSW from phase 18's index, levels linked on the card
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "index.hnsw")
            t0 = time.time()
            hnsw.from_cagra(cg, path, hnsw.HnswParams(hierarchy="tpu"))
            print(f"# hnsw from_cagra, device hierarchy: {time.time() - t0:.1f} s, "
                  f"{os.path.getsize(path) / 2**20:.0f} MiB")
            levels, maxlevel, enter, links = hnsw.read_hierarchy(path)
            nodes = np.where(levels >= 1)[0]
            m = (cg.graph_degree + 1) // 2
            xh = cg.dataset.float().cpu().numpy()
            host = nodes[hnsw._level_knn_host(xh[nodes], min(m, len(nodes) - 1))]
            differ = 0
            for row, node in enumerate(nodes):
                ln = links[(int(node), 1)]
                if not np.array_equal(ln, host[row]):
                    dd = lambda ids: ((xh[ids] - xh[node]) ** 2).sum(1)  # noqa: E731
                    check(np.allclose(np.sort(dd(ln)), np.sort(dd(host[row])), rtol=1e-5),
                          f"hnsw: level-1 links of node {node} differ from the host's beyond ties")
                    differ += 1
            print(f"# hnsw: {len(nodes)} nodes on level 1 of {maxlevel}; their links equal the "
                  f"host's but at ties ({differ} rows reordered)")
            t0 = time.time()
            loaded = hnsw.load(path, metric=ds.metric)
            print(f"# hnsw load: {time.time() - t0:.1f} s")
        ref = cagra.from_graph(x, cg.graph, metric=ds.metric)
        (a, b), (c, e) = (hnsw.search(loaded, q, K, ef=64, query_chunk=NQ),
                          cagra.search(ref, q, K, itopk_size=64, query_chunk=NQ))
        check(torch.equal(a, c) and torch.equal(b, e),
              "hnsw: the loaded file searches otherwise than cagra over the same graph")
        cagra_phase("hnsw_ef64", lambda qq: hnsw.search(loaded, qq, K, ef=64, query_chunk=NQ))
        del loaded, ref, xh
        phase_peak("hnsw")
        # 29. ScaNN: 1024 lists, eta 2.0, lambda 1.5, pq_dim 64 of 8 bits, a bf16 dataset copy
        split29 = {}
        held29 = torch.cuda.memory_allocated(dev)
        t0 = time.time()
        with timed_calls([(kmeans_balanced, "fit"), (kmeans_balanced, "predict"),
                          (scann, "_avq_refine"), (scann, "_soar_assign"),
                          (quantize, "pq_train"), (quantize, "pq_transform")], split29):
            sc = scann.build(x, n_lists=Q_LISTS, partitioning_eta=2.0, soar_lambda=1.5,
                             pq_dim=64, pq_bits=8, reordering_bf16=True, metric=ds.metric, seed=0)
        torch.cuda.synchronize()
        sec = {key: v[0] for key, v in split29.items()}
        print(f"# scann build: {time.time() - t0:.1f} s (k-means {sec['fit']:.1f} + predict "
              f"{sec['predict']:.1f}; AVQ {sec['_avq_refine']:.1f}; SOAR {sec['_soar_assign']:.1f};"
              f" PQ train {sec['pq_train']:.1f} + encode {sec['pq_transform']:.1f})")
        check(not bool((sc.soar_labels == sc.labels).any()), "scann: a SOAR label equals its primary")
        scann_peak = (torch.cuda.max_memory_allocated(dev) - held29) / 2**30
        print(f"# scann build: peak {scann_peak:.2f} GiB above the {held29 / 2**30:.2f} GiB held")
        check(scann_peak < 16.0, "scann build: more than 16 GiB above what earlier phases hold")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            scann.serialize(sc, tmp)
            back = scann.deserialize(tmp)
            for name in ("centers", "labels", "soar_labels", "codes", "pq_codebooks", "codes_soar",
                         "bf16_dataset"):
                check(torch.equal(getattr(back, name), getattr(sc, name)),
                      f"scann: {name} differs after serialize and deserialize")
            print(f"# scann assets: serialize + deserialize {time.time() - t0:.1f} s, every array "
                  "equal")
        del sc, back
        phase_peak("scann")
        # 30-39: multi-GPU and the serving composition, four shards on one card where they shard
        t30 = time.time()
        devs = [dev] * 4
        d2, i2 = results["bf_fused_exact_f32"]["out"]

        def built(label, fn):
            """Build, print the seconds; the phase's peak is printed by phase_peak."""
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            secs = time.time() - t0
            print(f"# {label} build: {secs:.1f} s")
            return out

        def checked_phase(label, fn, gt=None):
            """A phase held against the plain versions at once, so its index can go
            before the next phase. Returns its result."""
            phase(label, fn, gt)
            r = results.pop(label)
            t0 = time.time()
            with plain_versions():
                plain_rec = id_recall(fn(q)[1].cpu(), r["gt"])
            print(f"# {label}: plain-version recall@10={plain_rec:.4f} ({time.time() - t0:.1f} s)")
            check(r["recall"] >= plain_rec - RECALL_SLACK,
                  f"{label}: kernel recall {r['recall']:.4f} < plain {plain_rec:.4f} - "
                  f"{RECALL_SLACK}")
            return r

        def exact_launches(fn):
            before = bf_topk.LAUNCHES["bf_topk_exact"]
            out = fn()
            torch.cuda.synchronize()
            return out, bf_topk.LAUNCHES["bf_topk_exact"] - before

        # 30. mg sharded brute force: four shards of 250,000 rows, the exact kernel
        mgb = built("mg brute_force 4 x 250k", lambda: mg.build(
            x, "brute_force", "sharded", devices=devs, metric=ds.metric))
        check([s.size for s in mgb.shards] == [n // 4] * 4, "mg brute force: shard sizes")
        with tagged("-mg-250k"):
            (md, mi), launched = exact_launches(lambda: mg.search(mgb, q, K, fused=True))
            check(launched == 4, f"mg brute force: {launched} exact launches a batch, not 4")
            check_same_ranking(md, mi, d2, i2, "mg sharded brute force against phase 2")
            checked_phase("mg_bf_sharded_exact_f32", lambda qq: mg.search(mgb, qq, K, fused=True))
        print("# mg sharded brute force: four exact launches a batch, ids equal phase 2's but at "
              "ties")
        del mgb, md, mi
        phase_peak("mg brute force")
        # 31. mg sharded IVF-Flat, distributed build: phase 5's centres, a quarter of the rows each
        mgi = built("mg ivf_flat 4 shards (distributed)", lambda: mg.build(
            x, "ivf_flat", "sharded", devices=devs, n_lists=N_LISTS, metric=ds.metric, seed=0,
            storage_dtype=torch.bfloat16))
        same_centres = all(torch.equal(s.centers, idx.centers) for s in mgi.shards)
        print(f"# mg ivf_flat: every shard's centres equal phase 5's: {same_centres}")
        with tagged("-mg"):
            r31 = checked_phase(f"mg_ivf_sharded_p{N_PROBES}",
                                lambda qq: mg.search(mgi, qq, K, params=sp))
        check(r31["recall"] >= results[f"ivf_fused_p{N_PROBES}"]["recall"] - RECALL_SLACK,
              "mg sharded IVF-Flat recall more than 0.005 below phase 5's")
        phase_peak("mg ivf_flat")
        # 32. mg streaming IVF-PQ from 10 host slices: 3, 3, 3 and 1 slices a shard
        mgs = built("mg ivf_pq streaming 4 shards", lambda: mg.build_streaming(
            slices, n // SLICE, devices=devs, n_lists=256, metric=ds.metric, seed=0,
            algo="ivf_pq", pq_dim=64, pq_bits=8))
        check([s.n_rows for s in mgs.shards] == [3 * SLICE] * 3 + [SLICE],
              "mg streaming IVF-PQ: shard sizes")
        with tagged("-mg"):
            r32 = checked_phase(f"mg_ivf_pq_stream_p{Q_PROBES}_refine", lambda qq: refine.refine(
                x, qq, mg.search(mgs, qq, CAND, params=pq_sp[torch.bfloat16])[1], K,
                metric=ds.metric))
        check(r32["recall"] >= 0.80,
              "mg streaming IVF-PQ + refine below recall 0.80")
        phase_peak("mg ivf_pq streaming")
        # 33. mg replicated IVF-Flat over 4 replicas: round robin, then load balancer
        mgr = built("mg ivf_flat replicated x4", lambda: mg.build(
            x, "ivf_flat", "replicated", devices=devs, n_lists=N_LISTS, metric=ds.metric, seed=0,
            storage_dtype=torch.bfloat16))
        check(all(s.sorted_data.data_ptr() == mgr.shards[0].sorted_data.data_ptr()
                  for s in mgr.shards), "mg replicated: replicas on one card are copies")
        with tagged("-mg"):
            dd, di = ivf_flat.search(mgr.shards[0], q, K, sp)
            visited = set()
            for _ in range(4):
                tick = snmg._rr_counter[0]
                rd, ri = mg.search(mgr, q, K, routing="round_robin", params=sp)
                visited.add(tick % 4)
                check(torch.equal(ri, di) and torch.equal(rd, dd),
                      "mg round robin: ids differ from a direct search of the replica")
            check(visited == {0, 1, 2, 3}, "mg round robin: 4 calls did not visit every replica")
            r33 = checked_phase(f"mg_ivf_replicated_lb_p{N_PROBES}",
                                lambda qq: mg.search(mgr, qq, K, params=sp))
        direct = id_recall(di.cpu(), gti)
        print(f"# mg replicated: round robin visited every replica, ids equal a direct search; "
              f"direct recall {direct:.4f}")
        check(abs(r33["recall"] - direct) <= RECALL_SLACK,
              "mg load balancer recall more than 0.005 from a direct search's")
        del mgr, dd, di, rd, ri
        phase_peak("mg ivf_flat replicated")
        # 34. mg sharded CAGRA (the reference's default algo) of the first PART_ROWS rows,
        # 64 -> 32 per shard
        shard_secs, cagra_build = [], cagra.build

        def timed_build(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = cagra_build(*a, **kw)
            torch.cuda.synchronize()
            shard_secs.append(time.time() - t0)
            return out

        cagra.build = timed_build
        try:
            mgc = built(f"mg cagra 4 x {PART_ROWS // 4000}k 64 -> 32", lambda: mg.build(
                x[:PART_ROWS], "cagra", "sharded", devices=devs, intermediate_graph_degree=64,
                graph_degree=32, metric=ds.metric, seed=0))
        finally:
            cagra.build = cagra_build
        print("# mg cagra build seconds per shard: " + ", ".join(f"{s:.1f}" for s in shard_secs))
        cagra_phase("mg_cagra_sharded_itopk64",
                    lambda qq: mg.search(mgc, qq, K, params=cg_sp[64]), gt=gt_part)
        check(cg_res["mg_cagra_sharded_itopk64"]["recall"] >= 0.80,
              "mg sharded CAGRA below recall 0.80")
        del mgc
        phase_peak("mg cagra")
        # 35. mg save and load of phases 31 and 32: bit-identical searches, equal headers
        with tempfile.TemporaryDirectory() as tmp:
            for label, mgx, kw, kk in (("ivf_flat", mgi, dict(params=sp), K),
                                       ("ivf_pq streaming", mgs,
                                        dict(params=pq_sp[torch.bfloat16]), CAND)):
                t0 = time.time()
                path = os.path.join(tmp, label.replace(" ", "_"))
                snmg.save(path, mgx)
                back = snmg.load(path, devices=devs)
                torch.cuda.synchronize()
                check((back.algo, back.mode, back.n_rows, back.row_offsets)
                      == (mgx.algo, mgx.mode, mgx.n_rows, mgx.row_offsets),
                      f"mg {label}: header fields differ after save and load")
                with tagged("-mg"):
                    (a, b), (c, e) = mg.search(mgx, q, kk, **kw), mg.search(back, q, kk, **kw)
                check(torch.equal(a, c) and torch.equal(b, e),
                      f"mg {label}: search differs after save and load")
                print(f"# mg {label}: save + load, searches bit-identical ({time.time() - t0:.1f} s)")
                del back
        del mgi, mgs
        phase_peak("mg save and load")
        # 36. k-means: 1024 clusters, 20 iterations, single card and 4 shards
        split36 = {}
        t0 = time.time()
        with timed_calls([(kmeans, "_kmeans_pp_init"), (kmeans, "_lloyd")], split36):
            kc, _, k_inertia, k_iter = kmeans.fit(x, n_clusters=1024, max_iter=20, seed=0)
            torch.cuda.synchronize()
            sg_s, sg_seed = time.time() - t0, split36["_kmeans_pp_init"][0]
            c0 = split36["_kmeans_pp_init"][1]
            t0 = time.time()
            mgk_c, mgk_inertia = mg.kmeans_fit(x, 1024, devices=devs, max_iter=20, seed=0)
            torch.cuda.synchronize()
            mg_s, mg_seed = time.time() - t0, split36["_kmeans_pp_init"][0] - sg_seed
        print(f"# kmeans 1024 clusters on 1M rows: {sg_s:.2f} s (k-means++ seeding {sg_seed:.2f} "
              f"s, Lloyd {k_iter} iterations {split36['_lloyd'][0]:.2f} s), inertia "
              f"{float(k_inertia):.6g}")
        print(f"# mg kmeans 4 shards: {mg_s:.2f} s (k-means++ seeding on a subsample of 32768 "
              f"rows {mg_seed:.2f} s, Lloyd 20 iterations at most {mg_s - mg_seed:.2f} s), "
              f"inertia {float(mgk_inertia):.6g}")
        t0 = time.time()
        sg2, _, sg2_inertia, _ = kmeans.fit(x, n_clusters=1024, max_iter=20, init_centers=c0)
        mg2, _ = mg.kmeans_fit(x, 1024, devices=devs, max_iter=20, init_centers=c0)
        mg2_cost = float(kmeans.cluster_cost(x, mg2))
        rel = abs(mg2_cost - float(sg2_inertia)) / float(sg2_inertia)
        print(f"# mg Lloyd from the single-card fit's initial centres: inertia {mg2_cost:.6g} "
              f"against {float(sg2_inertia):.6g} (relative {rel:.2e}; {time.time() - t0:.1f} s)")
        check(rel <= 1e-3, "mg k-means inertia more than 1e-3 from the single-card fit's")
        del kc, mgk_c, sg2, mg2, c0, split36
        phase_peak("kmeans")
        # 37. tiered index over IVF-Flat: ANN tier on 900k rows, 100k in the hot tier
        ann_params = ivf_flat.IndexParams(n_lists=N_LISTS, metric=ds.metric, seed=0,
                                          storage_dtype=torch.bfloat16)
        tix = built("tiered ivf_flat 900k + 100k hot", lambda: tiered_index.extend(
            tiered_index.build(ivf_flat, x[:N_FIRST], ann_params, min_ann_rows=100_000,
                               metric=ds.metric), x[N_FIRST:]))
        check(tix.ann_rows == N_FIRST and tix.bf_data.shape[0] == n - N_FIRST,
              "tiered: the last 100k rows are not in the hot tier")
        ext = results[f"ivf_extend_fused_p{N_PROBES}"]["recall"]
        with tagged("-tiered"):  # the exact kernel's call here is the hot tier's, on 100k rows
            (td, ti_), launched = exact_launches(lambda: tiered_index.search(tix, q, K, params=sp))
            check(launched == 1, "tiered: the hot tier did not run the exact kernel once")
            r37 = checked_phase(f"tiered_ivf_p{N_PROBES}",
                                lambda qq: tiered_index.search(tix, qq, K, params=sp))
        check(r37["recall"] >= ext - RECALL_SLACK,
              "tiered recall more than 0.005 below phase 10's")
        with tempfile.TemporaryDirectory() as tmp:
            tiered_index.save(tmp, tix)
            back = tiered_index.load(tmp)
            with tagged("-tiered"):
                bd, bi = tiered_index.search(back, q, K, params=sp)
            check(torch.equal(bd, td) and torch.equal(bi, ti_),
                  "tiered: search differs after save and load")
            del back
        print("# tiered: save + load, searches bit-identical")
        t0 = time.time()
        tix = tiered_index.compact(tix)
        torch.cuda.synchronize()
        print(f"# tiered compact: {time.time() - t0:.1f} s")
        with tagged("-tiered"):
            r37c = checked_phase(f"tiered_compacted_p{N_PROBES}",
                                 lambda qq: tiered_index.search(tix, qq, K, params=sp))
        check(abs(r37c["recall"] - ext) <= RECALL_SLACK,
              "compacted tiered recall more than 0.005 from phase 10's")
        del tix, td, ti_
        phase_peak("tiered")
        # 38. the host library's dataset files, then offloaded IVF-PQ and the host-refined index
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "base.fbin")
            base32 = np.ascontiguousarray(base, np.float32)
            t0 = time.time()
            cio.write_bin(path, base32)
            with cio.BinDataset(path) as reader:
                check(reader.shape == base32.shape, "BinDataset: shape")
                check(np.array_equal(reader.read(), base32), "BinDataset.read: rows differ")
                check(np.array_equal(np.concatenate(list(reader.batches(SLICE))), base32),
                      "BinDataset.batches: rows differ")
                print(f"# io: write_bin + read + batches of {os.path.getsize(path) / 2**20:.0f} "
                      f"MiB, byte-identical ({time.time() - t0:.1f} s)")
                off = built("offload ivf_pq 4 shards from the .fbin", lambda: offload.build(
                    reader, "ivf_pq", n_shards=4, n_lists=256, pq_dim=64, pq_bits=8,
                    metric=ds.metric, seed=0))
                check(all(t.is_pinned() for s in off.shards for t in (s.centers, s.sorted_codes)),
                      "offload: shard tensors are not in pinned memory")
                shard_bytes = max(index_bytes(s) for s in off.shards)
                with tagged("-offload"):
                    # one shard's search workspace, that shard alone on the card
                    work = 0
                    for sub_host in off.shards:
                        sub = offload._to_device(sub_host, dev)
                        torch.cuda.synchronize()
                        held = torch.cuda.memory_allocated(dev)
                        torch.cuda.reset_peak_memory_stats(dev)
                        ivf_pq.search(sub, q, K, pq_sp[torch.bfloat16])
                        torch.cuda.synchronize()
                        work = max(work, torch.cuda.max_memory_allocated(dev) - held)
                        del sub
                    torch.cuda.synchronize()
                    held = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    od, oi = offload.search(off, q, K, params=pq_sp[torch.bfloat16])
                    torch.cuda.synchronize()
                    above = torch.cuda.max_memory_allocated(dev) - held
                    partials = 4 * NQ * K * 8
                    print(f"# offload search: peak {above / 2**30:.3f} GiB above the "
                          f"{held / 2**30:.2f} GiB held; largest shard {shard_bytes / 2**30:.3f} "
                          f"GiB, one shard's search workspace {work / 2**30:.3f} GiB")
                    # 16 MiB of slack: a second shard on the card (33 MiB) would break it
                    check(above <= shard_bytes + partials + work + 2**24,
                          "offload search: more than one shard + partials + one search's "
                          "workspace + 16 MiB on the card")
                    r38 = checked_phase(f"offload_ivf_pq_p{Q_PROBES}", lambda qq: tuple(
                        torch.from_numpy(a) for a in offload.search(
                            off, qq, K, params=pq_sp[torch.bfloat16])))
                check(r38["recall"] >= 0.75,
                      "offloaded IVF-PQ below recall 0.75")
                del off, od, oi
                hr = built("host-refined ivf_flat int8 from the .fbin",
                              lambda: offload.build_host_refined(
                                  reader, "ivf_flat", n_lists=N_LISTS, metric=ds.metric, seed=0,
                                  storage_dtype=torch.int8))
                with tagged("-host-refined"):
                    r38u = checked_phase(f"host_refined_ivf_int8_p{N_PROBES}",
                                         lambda qq: ivf_flat.search(hr.device_index, qq, K, fused8))
                    r38r = checked_phase(f"host_refined_ivf_int8_p{N_PROBES}_refine",
                                         lambda qq: offload.search_refined(hr, qq, K,
                                                                           refine_ratio=4,
                                                                           params=fused8))
                check(r38r["recall"] >= r38u["recall"],
                      "host-refined search: recall below the same index's unrefined search")
                del hr
        phase_peak("io and offload")
        # 39. dynamic batching over phase 2's index: 4096 single-query requests, 16 threads
        qh = q.cpu().numpy()
        for backend in ("python", "native"):
            bsr = dynamic_batching.wrap(brute_force, bf, dim, dynamic_batching.BatchParams(
                k=K, max_batch_size=1024), backend=backend, fused=True)
            answers = [None] * NQ

            def client(c, _bsr=bsr, _answers=answers):
                futs = [(j, _bsr.submit(qh[j])) for j in range(c, NQ, 16)]
                for j, fut in futs:
                    _answers[j] = fut.result(timeout=120)

            with tagged("-batched"):
                threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
                t0 = time.time()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                secs = time.time() - t0
            st = bsr.stats()
            bsr.close()
            check(all(a is not None for a in answers), f"batched {backend}: unanswered requests")
            bd_ = torch.from_numpy(np.concatenate([a[0] for a in answers]))
            bi_ = torch.from_numpy(np.concatenate([a[1] for a in answers]))
            check_same_ranking(bd_, bi_, d2, i2, f"batched {backend} against phase 2")
            check(st["max_batch_rows"] > 1, f"batched {backend}: no batch held two requests")
            print(f"# dynamic batching ({backend}): {NQ} requests from 16 threads in {secs:.2f} s "
                  f"= {NQ / secs:.0f} requests/s; largest batch {st['max_batch_rows']}; latency "
                  f"p50 {st['latency_p50_ms']:.2f} ms, p95 {st['latency_p95_ms']:.2f} ms; answers "
                  f"equal phase 2's but at ties")
        phase_peak("dynamic batching")
        print(f"# phases 30-39: {time.time() - t30:.1f} s")
        # 40-48: the long tail; no kernel of the path runs in this process (phase 48's
        # fused search runs in a subprocess, outside these counters)
        before = launch_counts()
        t40 = time.time()
        long_tail(dev, smi, ds, x, q, gti, d2, i2, results["bf_fused_exact_f32"]["qps"])
        check(launch_counts() == before,
              "phases 40-48 launched a kernel in this process")
        print(f"# phases 40-48: {time.time() - t40:.1f} s")
        # 49. the bench CLI, then the f32 approximate kernel and a traced IVF-PQ search
        torch.cuda.synchronize()
        held49 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t49 = time.time()
        bench_cli_phase(dev, smi, ds, bf, pq, pq_sp[torch.bfloat16], q, gti, results, tagged)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        print(f"# phase 49 bench CLI: {time.time() - t49:.1f} s, peak "
              f"{(peaks[-1] - held49) / 2**30:.2f} GiB above the {held49 / 2**30:.2f} GiB held "
              f"({smi})")
    torch.cuda.synchronize()
    peak = max(*peaks, torch.cuda.max_memory_allocated(dev))
    print(f"# peak device memory: {peak / 2**30:.2f} GiB")
    launches = launch_counts()
    print("# launches during the main path: " + json.dumps(launches))
    for name, *_ in kernels():
        check(launches[name] > 0, f"kernel {name} was not launched by the main path")

    # each approximate phase against the same search on the plain versions
    with plain_versions():
        for label, r in results.items():
            t0 = time.time()
            d, i = r["fn"](q)
            plain_rec = id_recall(i.cpu(), r["gt"])
            print(f"# {label}: plain-version recall@10={plain_rec:.4f} ({time.time() - t0:.1f} s)")
            check(r["recall"] >= plain_rec - RECALL_SLACK,
                  f"{label}: kernel recall {r['recall']:.4f} < plain {plain_rec:.4f} - "
                  f"{RECALL_SLACK}")
    for label, r in results.items():
        base = results.get(label.removesuffix("_refine"))
        if label.endswith("_refine") and base is not None:
            check(r["recall"] >= base["recall"],
                  f"{label}: recall {r['recall']:.4f} below the unrefined {base['recall']:.4f}")
    check(results["bf_int8_fused_refine"]["recall"] > 0.9, "int8 + refine recall too low")

    # each kernel against its plain version on the path's own inputs
    report = []
    for name, mod, wrapper, plain, source, replaces in kernels():
        variants = {}
        for (kname, var), (args, kw) in sorted(calls.items()):
            if kname != name:
                continue
            ms, out = cuda_ms(lambda: getattr(mod, wrapper)(*args, **kw))
            plain_ms, ref = cuda_ms(lambda: getattr(mod, plain)(*args, **kw))
            kind = ("exact" if name == "pool_topk" else "int8lut" if var.startswith("pq-int8lut")
                    else "int" if var == "int8" else "float")
            if name == "cagra_beam":  # the bound counts the loop's walk
                err, same = compare_walks(out, ref)
                bound = roofline.kernel_bound(name, args, kw, ref)
            else:
                err, same = compare_pools(out, ref, kind)
                bound = roofline.kernel_bound(name, args, kw, out)
            v = dict(launches=counts[(name, var)], ms=ms, plain_ms=plain_ms, max_abs_err=err,
                     **bound, library_ms=None)
            v["share"] = v["bound_ms"] / ms
            if mod is bf_topk:
                v["product_ms"] = roofline.product_ms(args[0], args[1])
            if name == "pq_scan":  # the instantiation it ran, and its source
                v["kernel"] = scan_compare.pq_kernel_attributes(args, kw)
                v["source"] = os.path.join(os.path.dirname(source), v["kernel"]["source"])
            elif kw.get("cap", 2) > 2:  # the deep bins' source
                v["source"] = source.replace(".cu", "_deep.cu")
            shape = "x".join(str(s) for s in out[0].shape)
            print(f"# {name} [{var}], {v['launches']} launches: pool {shape} matches plain "
                  f"(max abs err {err:.3g}, "
                  f"bit-identical: {same}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {v['bound_ms']:.3f} ms ({v['bound_by']}, share {v['share']:.3f})"
                  + (f", cuBLAS product {v['product_ms']:.3f} ms" if "product_ms" in v else "")
                  + (f"; {v['kernel']['source']}, {v['kernel']['slots']} slots, depth class "
                     f"{v['kernel']['depth']}, {v['kernel']['registers']} registers, "
                     f"{v['kernel']['local_bytes']} local bytes" if "kernel" in v else ""))
            variants[var] = v
        check(variants, f"no recorded call of {name}")
        # headline: the bf16 call where the path makes one (the rest are in variants)
        head = (variants.get("bfloat16") or variants.get("pq-bf16") or variants.get("offs-fetch40")
                or variants.get(CELL_BEAM) or next(iter(variants.values())))
        report.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                           launches=launches[name],
                           max_abs_err=max(v["max_abs_err"] for v in variants.values()),
                           **{key: head.get(key) for key in (
                               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "share",
                               "product_ms")},
                           variants=variants))
    print(json.dumps({"kernels": report}))
    print(f"# total: {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
