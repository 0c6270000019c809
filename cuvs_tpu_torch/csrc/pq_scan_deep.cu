// Fused quantized-code IVF scan, deep bins: pq_scan_kernel (pq_scan.cuh) at
// cap 3-32, which every IVF-PQ or IVF-RaBitQ search with k > 64 runs (cap =
// ceil(k / 32): k = 100 gives 4) and CAGRA's IVF-PQ graph build ((k + 1) *
// refine_ratio candidates: 194 gives 7, cuVS's default 258 gives 9).
//
// The design of cap 2, several slots per block and one decode per row, with
// the bins at a compile-time depth class D >= cap, 4, 8, 16 or 32: the chain
// is prefix-stable, so the D-deep bins cut to cap levels are the cap-deep
// bins. The bins cost no registers at any depth: the table build sets the
// kernel's peak, and the bins are set after it (NVIDIA H100, ptxas: PQ 8-bit
// with a bf16 table 122 registers at every D, no spill). Blocks per SM:
//  * PQ 8-bit, bf16 table: 4 slots (128 KB of table), one block per SM.
//  * PQ 8-bit, int8 table: 4 slots, one block per SM. Two would fit the
//    shared memory (64 KB of table), but not the registers: at 64 a thread
//    spills 244 B at every depth (as cap 2 does), at one block none.
//  * RaBitQ 3-bit: 8 slots (two bins a thread), two blocks per SM at D <= 8
//    (64 registers, no spill), one at D = 16 and 32 (108 and 128).
//  * Every other width and book: the most slots (4, 2, 1) that fit one block
//    per SM, the codes through the 64-bit bit buffer.
#include "pq_scan.cuh"

namespace cuvs_tpu_torch {
namespace pq {

namespace {

// Instantiation families: the 8-bit PQ and 3-bit RaBitQ codes with a full
// book (compile-time decode), and every other width and book.
enum Kind { kGeneric = 0, kPq8 = 1, kRabitq3 = 2 };

// kD<D>: the blocks per SM that the registers of depth class D allow
template <typename T, int kSlots, int kBits, int kD4, int kD8, int kD16, int kD32>
cudaError_t launch_classes(int n_tiles, cudaStream_t st, const Args& a) {
  if (a.cap <= 4)
    return launch_scan_kernel(pq_scan_kernel<T, kSlots, 4, kBits, kD4>, kSlots, n_tiles, st, a);
  if (a.cap <= 8)
    return launch_scan_kernel(pq_scan_kernel<T, kSlots, 8, kBits, kD8>, kSlots, n_tiles, st, a);
  if (a.cap <= 16)
    return launch_scan_kernel(pq_scan_kernel<T, kSlots, 16, kBits, kD16>, kSlots, n_tiles, st, a);
  return launch_scan_kernel(pq_scan_kernel<T, kSlots, 32, kBits, kD32>, kSlots, n_tiles, st, a);
}

template <typename T>
cudaError_t launch_generic(int slots, int n_tiles, cudaStream_t st, const Args& a) {
  switch (slots) {
    case 4: return launch_classes<T, 4, 0, 1, 1, 1, 1>(n_tiles, st, a);
    case 2: return launch_classes<T, 2, 0, 1, 1, 1, 1>(n_tiles, st, a);
    default: return launch_classes<T, 1, 0, 1, 1, 1, 1>(n_tiles, st, a);
  }
}

}  // namespace

// The 8-bit PQ family where 4 slots fit one block per SM, the 3-bit RaBitQ
// family where 8 slots fit two; else the most slots (4, 2, 1) that fit one
// block per SM, never wider than the tile needs.
DeepPlan plan_deep(const Args& a) {
  if (a.bits == 8 && a.book == 256 && scan_smem(4, a) <= smem_limit(false)) return {4, kPq8};
  if (a.bits == 3 && a.book == 8 && !a.int8_mode && scan_smem(8, a) <= smem_limit(true))
    return {8, kRabitq3};
  for (int G = 4; G >= 1; G /= 2) {
    if (G > 1 && G / 2 >= a.M) continue;
    if (scan_smem(G, a) <= smem_limit(false)) return {G, kGeneric};
  }
  return {};
}

cudaError_t launch_deep(const DeepPlan& p, int n_tiles, cudaStream_t st, const Args& a) {
  using bf16 = __nv_bfloat16;
  if (a.cap < 3 || a.cap > kMaxCap) return cudaErrorInvalidValue;
  switch (p.kind) {
    case kPq8:
      return a.int8_mode ? launch_classes<int8_t, 4, 8, 1, 1, 1, 1>(n_tiles, st, a)
                         : launch_classes<bf16, 4, 8, 1, 1, 1, 1>(n_tiles, st, a);
    case kRabitq3:
      return launch_classes<bf16, 8, 3, 2, 2, 1, 1>(n_tiles, st, a);
    default:
      return a.int8_mode ? launch_generic<int8_t>(p.slots, n_tiles, st, a)
                         : launch_generic<bf16>(p.slots, n_tiles, st, a);
  }
}

}  // namespace pq
}  // namespace cuvs_tpu_torch
