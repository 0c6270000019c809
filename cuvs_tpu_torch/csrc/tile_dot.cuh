// Block geometry and the shared-memory dot-product tile of the fused IVF
// scan's float path (ivf_scan.cu: f32 rows, or f32 and bf16 mixed), its only
// user: bf16 and int8 rows run on tensor cores (mma_tile.cuh).
//
// A block owns kBQ query rows and walks a run of 128-column slices of the
// dataset. For every slice it stages the slice's 128 rows and its own kBQ
// query rows through shared memory as f32, kKW values of the row at a time
// (bf16 x f32 products are exact in f32), and each thread accumulates a
// kTQ x kTL micro-tile of dot products in registers: query rows tq*kTQ + i
// and lanes tl + 16*j. A lane is a column within the slice, which is also the
// strided bin of the TPU kernels (bin l collects columns l, l+128, ...), so a
// thread owns the same bins for the whole run and keeps their running best in
// registers.
#pragma once

#include "dtype.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cuvs_tpu_torch {

constexpr int kLanes = 128;                               // columns per slice
constexpr int kBQ = 64;                                   // query rows per block
constexpr int kTQ = 4;                                    // query rows per thread
constexpr int kTL = 8;                                    // lanes per thread
constexpr int kLaneThreads = kLanes / kTL;                // 16
constexpr int kThreads = (kBQ / kTQ) * kLaneThreads;      // 256
constexpr int kKW = 32;                                   // values staged per row
constexpr int kPad = kKW + 1;                             // odd stride: no bank conflicts

// Value w of a row of d elements, zero past the end of the row.
__device__ __forceinline__ float load_word(const float* row, int w, int d) {
  return w < d ? row[w] : 0.f;
}
__device__ __forceinline__ float load_word(const __nv_bfloat16* row, int w, int d) {
  return w < d ? __bfloat162float(row[w]) : 0.f;
}

// Stage values [w0, w0 + kKW) of `rows` rows into sm[rows][kPad]. row_ptr(r)
// gives row r's base pointer, or nullptr for a row that reads as zeros.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* sm, int rows, RowPtr row_ptr, int w0, int d) {
  for (int e = threadIdx.x; e < rows * kKW; e += kThreads) {
    int r = e / kKW, w = e % kKW;
    const T* p = row_ptr(r);
    sm[r * kPad + w] = p ? load_word(p, w0 + w, d) : 0.f;
  }
}

// acc[i][j] += <query row tq*kTQ+i, slice row tl+16*j> over the staged values.
__device__ __forceinline__ void tile_mac(const float* qs, const float* xs, int tq, int tl,
                                         float (&acc)[kTQ][kTL]) {
#pragma unroll 8
  for (int w = 0; w < kKW; ++w) {
    float a[kTQ], b[kTL];
#pragma unroll
    for (int i = 0; i < kTQ; ++i) a[i] = qs[(tq * kTQ + i) * kPad + w];
#pragma unroll
    for (int j = 0; j < kTL; ++j) b[j] = xs[(tl + kLaneThreads * j) * kPad + w];
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int j = 0; j < kTL; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Dot products of the block's query rows (element type TQ) with one 128-row
// slice (element type TX), over all of d. Leaves the block synchronised with
// the staging buffers free.
template <typename TQ, typename TX, typename QRow, typename XRow>
__device__ __forceinline__ void slice_dots(float* qs, float* xs, QRow q_row, XRow x_row, int d,
                                           int tq, int tl, float (&acc)[kTQ][kTL]) {
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j) acc[i][j] = 0.f;
  for (int w0 = 0; w0 < d; w0 += kKW) {
    stage_rows<TQ>(qs, kBQ, q_row, w0, d);
    stage_rows<TX>(xs, kLanes, x_row, w0, d);
    __syncthreads();
    tile_mac(qs, xs, tq, tl, acc);
    __syncthreads();
  }
}

}  // namespace cuvs_tpu_torch
