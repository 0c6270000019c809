// Register-blocked IEEE fp32 slice mainloop for the brute-force kernels
// (bf_topk.cu: the float32 rows of cuvs_tpu/ops/bf_topk_pallas.py's
// _fused_kernel (ground truth, which runs at Precision.HIGHEST on the TPU)
// and _approx_kernel) and for the IVF-Flat scan's float rows (ivf_scan.cu:
// f32 rows, and bf16 rows searched with f32 queries, of
// ivf_scan_pallas.py's _scan_kernel).
//
// Ground truth stays IEEE fp32: no TF32 and no split precision, so the
// products run on the CUDA cores and what bounds them on this card is
// 2 * B * N * d operations at 67 TFLOP/s. The design keeps the cores fed:
//
//  * 256 threads; a thread owns a kTM x 8 micro-tile of the block's
//    [16 * kTM queries x 128 columns] slice (rows ty + 16 i, columns
//    tx + 16 j), so every 16-byte shared-memory load feeds 4 * kTM or 32
//    multiply-adds (kTM = 8: 64 FMA per 4 k-steps for 16 loads).
//  * Queries (f32) and dataset rows (TX: float, or __nv_bfloat16 widened to
//    f32 as the tile reads it, which is exact) are staged row-major, 32
//    values of k per chunk with a row stride of 36 floats or 40 bf16,
//    double-buffered by cp.async (mma_tile.cuh); the 8 threads of a
//    quarter-warp read 8 different rows at one k and hit 8 different bank
//    groups. A caller whose query rows fit shared memory whole may keep them
//    resident (stage_queries) and stream only the dataset rows (stage_x).
//  * The caller orders the grid so that the query blocks of one tile run
//    together and share it through L2.
#pragma once

#include "mma_tile.cuh"

namespace cuvs_tpu_torch {

// Four staged values as f32; a bf16's bits are the top half of its f32's.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

template <int kTM, typename TX = float>
struct FmaTile {
  static constexpr int kBQ = 16 * kTM;
  static constexpr int kThreads = 256;
  static constexpr int kTN = 8;
  static constexpr int kBK = 32;                                         // values of k per chunk
  static constexpr int kXSize = static_cast<int>(sizeof(TX));
  static constexpr int kStride = kBK + 4;                                // query row, floats
  static constexpr int kXStride = kBK + 16 / kXSize;                     // dataset row, elements
  static constexpr int kStages = 2;
  static constexpr int kGroup = 1;
  static constexpr int kXStageBytes = kSliceRows * kXStride * kXSize;  // dataset rows alone
  static constexpr int kStageBytes = kBQ * kStride * 4 + kXStageBytes;
  static constexpr int kStageFloats = kStageBytes / 4;

  static __host__ __device__ int n_chunks_k(int d) { return (d + kBK - 1) / kBK; }
  static __host__ __device__ size_t smem_bytes() {
    return static_cast<size_t>(kStages) * kStageBytes;
  }

  static __device__ __forceinline__ int row_of(int i) { return threadIdx.x / 16 + 16 * i; }
  static __device__ __forceinline__ int col_of(int j) { return threadIdx.x % 16 + 16 * j; }

  // A slot holds the block's kBQ query rows, then 128 dataset rows. Thread t
  // stages 16-byte unit t % kQUnits of query rows t / kQUnits + kQStep m and
  // unit t % kXUnits of dataset rows t / kXUnits + kXStep m.
  static constexpr int kQUnits = kBK / 4;
  static constexpr int kXUnits = kBK * kXSize / 16;
  static constexpr int kQStep = kThreads / kQUnits;
  static constexpr int kXStep = kThreads / kXUnits;
  static constexpr int kQRows = kBQ / kQStep;
  static constexpr int kXRows = kSliceRows / kXStep;
  static_assert(kBQ % kQStep == 0 && kSliceRows % kXStep == 0, "staging rows");

  struct Rows {
    const float* q[kQRows];
    const TX* x[kXRows];
  };

  // The thread's staging rows of one slice: q_row(r) / x_row(r) give a row
  // or nullptr for zeros.
  template <typename XRow>
  static __device__ __forceinline__ void x_rows(const TX* (&p)[kXRows], XRow x_row) {
#pragma unroll
    for (int m = 0; m < kXRows; ++m) p[m] = x_row(threadIdx.x / kXUnits + kXStep * m);
  }
  template <typename QRow, typename XRow>
  static __device__ __forceinline__ void rows(Rows& p, QRow q_row, XRow x_row) {
#pragma unroll
    for (int m = 0; m < kQRows; ++m) p.q[m] = q_row(threadIdx.x / kQUnits + kQStep * m);
    x_rows(p.x, x_row);
  }

  // Stage chunk kc of the 128 dataset rows p into xs (rows kXStride apart).
  static __device__ __forceinline__ void stage_x(TX* xs, const TX* const (&p)[kXRows], int kc,
                                                 int d, bool vec) {
    constexpr int kPer = 16 / kXSize;
    const int ux = threadIdx.x % kXUnits;
#pragma unroll
    for (int m = 0; m < kXRows; ++m) {
      TX* dst = xs + (threadIdx.x / kXUnits + kXStep * m) * kXStride + kPer * ux;
      stage_unit(reinterpret_cast<char*>(dst), p[m], kc * kBK + kPer * ux, d, vec);
    }
  }

  // Stage chunk kc of the query and dataset rows into one ring slot.
  static __device__ __forceinline__ void stage(float* slot, const Rows& p, int kc, int d,
                                               bool vec) {
    const int uq = threadIdx.x % kQUnits;
#pragma unroll
    for (int m = 0; m < kQRows; ++m) {
      float* dst = slot + (threadIdx.x / kQUnits + kQStep * m) * kStride + 4 * uq;
      stage_unit(reinterpret_cast<char*>(dst), p.q[m], kc * kBK + 4 * uq, d, vec);
    }
    stage_x(reinterpret_cast<TX*>(slot + kBQ * kStride), p.x, kc, d, vec);
  }

  // Stage all nk chunks of the block's kBQ query rows into qs (rows q_stride
  // floats apart), to stay resident while the dataset rows stream past.
  template <typename QRow>
  static __device__ __forceinline__ void stage_queries(float* qs, int q_stride, QRow q_row,
                                                       int nk, int d, bool vec) {
    const int per_row = nk * kQUnits;
    for (int u = threadIdx.x; u < kBQ * per_row; u += kThreads) {
      const int r = u / per_row, e = 4 * (u % per_row);
      stage_unit(reinterpret_cast<char*>(qs + r * q_stride + e), q_row(r), e, d, vec);
    }
  }

  // acc[i][j] += <query row_of(i), dataset row col_of(j)> over one chunk of
  // one ring slot.
  static __device__ __forceinline__ void compute(const float* slot, float (&acc)[kTM][kTN]) {
    compute(slot, kStride, reinterpret_cast<const TX*>(slot + kBQ * kStride), acc);
  }

  // The same over kBK values of query rows q_stride floats apart from q0
  // and dataset rows kXStride apart from xs: columns col_of(j) for j < kN
  // (kN < kTN: the caller offsets xs to its first column group).
  template <int kN>
  static __device__ __forceinline__ void compute(const float* q0, int q_stride, const TX* xs,
                                                 float (&acc)[kTM][kN]) {
    const float* qs = q0 + (threadIdx.x / 16) * q_stride;
    xs += (threadIdx.x % 16) * kXStride;
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[kTM], b[kN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = load4(qs + 16 * i * q_stride + kk);
#pragma unroll
      for (int j = 0; j < kN; ++j) b[j] = load4(xs + 16 * j * kXStride + kk);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
};

}  // namespace cuvs_tpu_torch
