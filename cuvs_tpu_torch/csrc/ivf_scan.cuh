// Shared by the IVF-Flat scan's two kernels: ivf_scan.cu (bf16 and int8
// rows on tensor cores, and the C entry point) and ivf_scan_fma.cu (f32
// rows, and bf16 rows with f32 queries, on the fp32 tile). They are two
// sources so that nvcc builds them in parallel processes.
#pragma once

#include "dtype.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace cuvs_tpu_torch {

constexpr int kMaxCap = 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may take

// The cap-deep chain of one bin: strict >, the displaced entry moves down.
template <int kDepth>
__device__ __forceinline__ void chain_insert(float (&best)[kDepth], int (&bidx)[kDepth], int cap,
                                             float v, int vi) {
  if (!(v > best[cap - 1])) return;  // below the whole bin: no change
  for (int r = 0; r < cap; ++r) {
    if (v > best[r]) {
      const float ob = best[r];
      const int oi = bidx[r];
      best[r] = v;
      bidx[r] = vi;
      v = ob;
      vi = oi;
    }
  }
}

struct ScanArgs {
  const void* data;
  const float* norms;
  const void* q;
  const int *qidx, *al, *lo, *sizes;
  const float* scale;
  int n_tiles, M, dp, n_rows, W, cap, ip;
  float* out_v;
  uint8_t* out_i;
};

// ivf_scan_fma.cu, for TX = float and __nv_bfloat16 rows (f32 queries).
template <typename TX>
cudaError_t launch_fma(const ScanArgs& s, cudaStream_t st);

}  // namespace cuvs_tpu_torch
