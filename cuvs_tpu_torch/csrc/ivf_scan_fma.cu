// The fp32 IVF-Flat scan for Hopper (sm_90a): ivf_scan_fma_kernel replaces
// cuvs_tpu/ops/ivf_scan_pallas.py::_scan_kernel for f32 rows and for bf16
// rows searched with f32 queries (via fused_ivf_scan; the contract is
// ivf_scan.cu's).
//
// The design (f32 rows are IVF-Flat's default storage):
//  * IEEE fp32 on the CUDA cores, as the plain version and the brute
//    force's ground truth: no TF32, no split precision. At the bench CLI's
//    f32 IVF-Flat call (1M x 128, 1024 lists, 10,000 queries x 10 probes,
//    about 1e5 pairs of ~980 rows) the products are about 2.5e10 operations,
//    0.374 ms at 67 TFLOP/s, more than its bytes take (rows read once, pool
//    written once): operations bound it.
//  * The brute force's fp32 tile (fma_tile.cuh, FmaTile<4>): 256 threads, a
//    thread owns 4 slots x 8 lanes (16 FMA per float4 shared load) for the
//    whole window. The slots' query rows are gathered once through qidx (an
//    empty slot is a row of zeros) and stay in shared memory while the
//    window's 128-row slices stream through a three-slot cp.async ring, 32
//    values of k a chunk, one barrier a chunk, so the copies of the next
//    chunks overlap this one's products. Where the query rows do not fit
//    (dp above 672 with f32 rows, 768 with bf16) they stream through the
//    ring beside each slice instead (2-3.5% slower at dp = 128 on the
//    H100). bf16 rows are staged as bf16 and widened as the tile reads them
//    (exact), so a bf16 index is never cast per search; the wrapper widens
//    bf16 queries.
//  * A block none of whose 64 slots holds a query (a tile of a list probed
//    by at most 64 pairs leaves its second block empty: most lists at 4096
//    queries x 10 probes over 1024 lists) reads no row of the window: its
//    products are all 0, the plain version's zero query rows, so only the
//    penalties run through the chain and its pool is unchanged.
//  * The epilogue is the MMA kernel's (ivf_scan.cu): per slice each
//    accumulator is one (slot, lane bin) of one thread, penalty subtracted
//    with explicit roundings and chained in slice order (integer-valued rows
//    give pools bit-identical to the plain version's). State for cap 2 (64
//    values, 64 slice ids) sits in registers beside the 32 accumulators;
//    cap 1 runs it and writes level 0. Deeper bins: ivf_scan_deep.cu.
//  * The kernel (ivf_scan_fma_kernel) is a template of ivf_scan.cuh, which
//    the deep classes share; this source holds its cap-2 instantiations.
#include "ivf_scan.cuh"

namespace cuvs_tpu_torch {

cudaError_t launch_fma_cap2(int xdtype, const ScanArgs& s, cudaStream_t st) {
  return xdtype == kF32 ? launch_fma<float, 4, 2, 1>(s, st)
                        : launch_fma<__nv_bfloat16, 4, 2, 1>(s, st);
}

}  // namespace cuvs_tpu_torch
