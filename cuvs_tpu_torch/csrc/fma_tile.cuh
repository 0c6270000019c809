// Register-blocked IEEE fp32 slice mainloop for the brute-force kernels
// (bf_topk.cu): the float32 rows of cuvs_tpu/ops/bf_topk_pallas.py's
// _fused_kernel (ground truth, which runs at Precision.HIGHEST on the TPU)
// and _approx_kernel.
//
// Ground truth stays IEEE fp32: no TF32 and no split precision, so the
// products run on the CUDA cores and what bounds them on this card is
// 2 * B * N * d operations at 67 TFLOP/s. The design keeps the cores fed:
//
//  * 256 threads; a thread owns a kTM x 8 micro-tile of the block's
//    [16 * kTM queries x 128 columns] slice (rows ty + 16 i, columns
//    tx + 16 j), so every 16-byte shared-memory load feeds 4 * kTM or 32
//    multiply-adds (kTM = 8: 64 FMA per 4 k-steps for 16 loads).
//  * Queries and dataset rows are staged row-major, 32 floats of k per chunk
//    with a stride of 36 floats, double-buffered by cp.async (mma_tile.cuh);
//    the 8 threads of a quarter-warp read 8 different rows at one k and hit 8
//    different bank groups.
//  * The caller orders the grid so that the query blocks of one tile run
//    together and share it through L2.
#pragma once

#include "mma_tile.cuh"

namespace cuvs_tpu_torch {

template <int kTM>
struct FmaTile {
  static constexpr int kBQ = 16 * kTM;
  static constexpr int kThreads = 256;
  static constexpr int kTN = 8;
  static constexpr int kBK = 32;          // floats of k per chunk
  static constexpr int kStride = kBK + 4; // row stride in floats
  static constexpr int kStages = 2;
  static constexpr int kGroup = 1;
  static constexpr int kStageFloats = (kBQ + kSliceRows) * kStride;

  static __host__ __device__ int n_chunks_k(int d) { return (d + kBK - 1) / kBK; }
  static __host__ __device__ size_t smem_bytes() {
    return static_cast<size_t>(kStages) * kStageFloats * sizeof(float);
  }

  static __device__ __forceinline__ int row_of(int i) { return threadIdx.x / 16 + 16 * i; }
  static __device__ __forceinline__ int col_of(int j) { return threadIdx.x % 16 + 16 * j; }

  // A slot holds the block's kBQ query rows, then 128 dataset rows. Thread t
  // stages 16-byte unit t % kUnits of slot rows t / kUnits + kRowStep m.
  static constexpr int kUnits = kBK / 4;
  static constexpr int kRowStep = kThreads / kUnits;
  static constexpr int kRowsPerThread = (kBQ + kSliceRows) / kRowStep;

  // The thread's staging rows of one slice: q_row(r) / x_row(r) give a row
  // or nullptr for zeros.
  template <typename QRow, typename XRow>
  static __device__ __forceinline__ void rows(const float* (&p)[kRowsPerThread], QRow q_row,
                                              XRow x_row) {
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int r = threadIdx.x / kUnits + kRowStep * m;
      p[m] = r < kBQ ? q_row(r) : x_row(r - kBQ);
    }
  }

  // Stage chunk kc of those rows into one ring slot.
  static __device__ __forceinline__ void stage(float* slot, const float* const (&p)[kRowsPerThread],
                                               int kc, int d, bool vec) {
    const int u = threadIdx.x % kUnits;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      float* dst = slot + (threadIdx.x / kUnits + kRowStep * m) * kStride + 4 * u;
      stage_unit(reinterpret_cast<char*>(dst), p[m], kc * kBK + 4 * u, d, vec);
    }
  }

  // acc[i][j] += <query row_of(i), dataset row col_of(j)> over one chunk.
  static __device__ __forceinline__ void compute(const float* slot, float (&acc)[kTM][kTN]) {
    const float* qs = slot + (threadIdx.x / 16) * kStride;
    const float* xs = slot + (kBQ + threadIdx.x % 16) * kStride;
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + 16 * i * kStride + kk);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        b[j] = *reinterpret_cast<const float4*>(xs + 16 * j * kStride + kk);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
};

}  // namespace cuvs_tpu_torch
