// Lane bins of the IVF scans' insertion chain (ivf_scan.cuh, pq_scan.cuh),
// the TPU kernel's chain (cuvs_tpu/ops/ivf_scan_pallas.py:156-192): a score
// x inserted into a bin sorted by value walks its levels in order and
// swaps with every level it is strictly above, so the displaced entry moves
// on down and the last level drops it. At exact ties this is not a stable
// top-k: x at slice 3, x at slice 5, then v > x at slice 7 leaves
// [v@7, x@5], the displaced x@3 dropped at the equal x@5.
//
// The chain is prefix-stable: level r depends only on the inserted scores
// and levels < r, so a kDepth-deep chain cut to its first cap levels is the
// cap-deep chain, and a kernel may run any depth class kDepth >= cap.
#pragma once

#include <math.h>
#include <stdint.h>

namespace cuvs_tpu_torch {

// One lane bin's kDepth levels: scores, and their slice ids (< 256) packed
// four to a word (byte r % 4 of word r / 4). Every index is a compile-time
// constant once the loops are unrolled, so the bins stay in registers.
template <int kDepth>
struct Bins {
  static constexpr int kWords = (kDepth + 3) / 4;
  float v[kDepth];
  uint32_t id[kWords];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int r = 0; r < kDepth; ++r) v[r] = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWords; ++w) id[w] = 0;
  }

  __device__ __forceinline__ void insert(float x, uint32_t xi) {
    if (!(x > v[kDepth - 1])) return;  // below the whole bin: no change
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      if (x > v[r]) {
        constexpr uint32_t kByte = 0xffu;
        const int sh = 8 * (r % 4);
        const float ob = v[r];
        const uint32_t oi = (id[r / 4] >> sh) & kByte;
        v[r] = x;
        id[r / 4] = (id[r / 4] & ~(kByte << sh)) | (xi << sh);
        x = ob;
        xi = oi;
      }
    }
  }

  __device__ __forceinline__ uint32_t slice(int r) const {
    return (id[r / 4] >> (8 * (r % 4))) & 0xffu;
  }
};

// Two levels with their slice ids unpacked: the state of the IVF-Flat
// scan's cap-2 kernels, 32 of them beside 32 accumulators a thread.
struct Bins2 {
  float v[2];
  int id[2];

  __device__ __forceinline__ void clear() {
    v[0] = v[1] = -INFINITY;
    id[0] = id[1] = 0;
  }

  __device__ __forceinline__ void insert(float x, int xi) {
    if (!(x > v[1])) return;  // below the whole bin: no change
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (x > v[r]) {
        const float ob = v[r];
        const int oi = id[r];
        v[r] = x;
        id[r] = xi;
        x = ob;
        xi = oi;
      }
    }
  }

  __device__ __forceinline__ uint32_t slice(int r) const { return static_cast<uint32_t>(id[r]); }
};

}  // namespace cuvs_tpu_torch
