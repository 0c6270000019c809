// Fused IVF cluster-major scan for Hopper (sm_90a).
//
// ivf_scan replaces cuvs_tpu/ops/ivf_scan_pallas.py::_scan_kernel (via
// fused_ivf_scan). One pair tile from group_pairs_tiled holds M query slots
// that all probe one list; the tile scores its slots against the W-row window
// of sorted rows starting at al[t], with penalty 0.5*|y|^2/scale on window
// positions [lo, lo + size) and +inf elsewhere, and keeps the best `cap`
// scores per (slot, strided lane bin) by the TPU kernel's insertion chain
// (strict >). Output: f * best as [n_tiles, M, cap*128] f32 plus the uint8
// 128-slice id of each entry, f = -2*scale (L2) or -scale (IP).
//
// What bounds it on the card: at 1M x 128, 4096 queries, 64 probes the
// products are about 3.4e10 operations (0.03 ms of bf16 tensor-core time),
// and the least bytes (rows read once, pools written once) are about 0.9 GB,
// 0.28 ms, most of it the [tiles, M, cap*128] pool. The work per tile is
// short: a list of ~500 rows is 4-5 slices of 128 rows. So what bounds the
// kernel is latency and issue: gathering the tile's query rows, filling the
// pipeline, and the per-element epilogue. The first version multiplied with
// FMA from padded shared memory between two barriers per 32-word chunk.
//
// The design (bf16 and int8 rows, ivf_scan_mma_kernel):
//  * The brute-force kernels' tensor-core tile (mma_tile.cuh: mma.sync
//    m16n8k16 bf16 / m16n8k32 s8, ldmatrix from XOR-swizzled shared memory):
//    a block owns 64 slots of a tile (8 warps of 32 slots x 32 lanes); the
//    blocks of a tile are adjacent in the grid and share its window in L2.
//    The slots' query rows are gathered through qidx into the resident query
//    block (an empty slot is a row of zeros); the window's slices
//    [cc_lo, cc_hi) stream through the cp.async ring, two 128-byte chunks per
//    barrier, up to three groups in flight, so the loads of the next slices
//    overlap the products and the epilogue.
//  * The epilogue stays in registers: after each slice's products every
//    accumulator element is one (slot, lane bin), owned by one thread for the
//    whole window, which subtracts its penalty and runs the cap-deep chain in
//    slice order: the TPU kernel's ties, exactly. State for cap 2 (value and
//    slice, two deep, 32 elements) sits beside the 32 accumulators within the
//    255 registers of a 256-thread block; cap 1 runs it and writes level 0.
//    Deeper bins (cap 3-32) run ivf_scan_deep.cu's depth classes
//    (ivf_scan.cuh).
//  * int8 rows accumulate exactly in int32, so their pools are bit-identical
//    to the plain version's; bf16 rows sum the same exact products in the
//    tensor cores' order (rtol 1e-4 / atol 1e-3 of the plain version).
//  * f32 rows, and bf16 rows with f32 queries, run on the fp32 tile
//    (ivf_scan_fma.cu).
// The kernels are templates of ivf_scan.cuh; this source holds the C entry
// point and the tensor-core kernel's cap-2 instantiations.
// Both kernels read norms by plain index into the flat sorted_norms and skip the
// window slices that hold no row of the list, which changes no output: every
// score there is -inf and never inserted.
#include "ivf_scan.cuh"

namespace cuvs_tpu_torch {
namespace {

cudaError_t launch(int dtype, int qdtype, const ScanArgs& s, cudaStream_t st) {
  const bool mma = dtype == qdtype && (dtype == kI8 || dtype == kBF16);
  if (!mma && !(qdtype == kF32 && (dtype == kF32 || dtype == kBF16)))
    return cudaErrorInvalidValue;
  if (s.cap > 2) return launch_deep(dtype, qdtype, s, st);
  if (!mma) return launch_fma_cap2(dtype, s, st);
  return dtype == kI8 ? launch_mma<int8_t, 2, 2, 1>(s, st)
                      : launch_mma<__nv_bfloat16, 2, 2, 1>(s, st);
}

}  // namespace
}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch;

extern "C" int cuvs_ivf_scan(int dtype, int qdtype, const void* data, const float* norms,
                             const void* q, const int* qidx, const int* al, const int* lo,
                             const int* sizes, const float* scale, int n_tiles, int M, int dp,
                             int n_rows, int W, int cap, int ip, float* out_v, uint8_t* out_i,
                             void* stream) {
  if (cap < 1 || cap > kMaxCap || W % kSliceRows || W / kSliceRows > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs s{data, norms, q, qidx, al, lo, sizes, scale, n_tiles, M, dp, n_rows, W, cap,
                   ip, out_v, out_i, nullptr};
  return static_cast<int>(launch(dtype, qdtype, s, static_cast<cudaStream_t>(stream)));
}

// The kernel that cuvs_ivf_scan would run for these shapes, without running
// it: out[0..5] = registers, local (stack) bytes a thread, depth class, slots
// a block, column parts, threads a block.
extern "C" int cuvs_ivf_scan_attributes(int dtype, int qdtype, int M, int dp, int W, int cap,
                                        int* out) {
  if (cap < 1 || cap > kMaxCap || W % kSliceRows || W / kSliceRows > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs s{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, M,
                   dp, 0, W, cap, 0, nullptr, nullptr, out};
  return static_cast<int>(launch(dtype, qdtype, s, nullptr));
}
