// Shared block geometry and the shared-memory dot-product tile used by the
// three search kernels (bf_topk.cu, ivf_scan.cu).
//
// A block owns kBQ query rows and walks a run of 128-column slices of the
// dataset. For every slice it stages the slice's 128 rows and its own kBQ
// query rows through shared memory, kKW words of the row at a time, and each
// thread accumulates a kTQ x kTL micro-tile of dot products in registers:
// query rows tq*kTQ + i and lanes tl + 16*j. A lane is a column within the
// slice, which is also the strided bin of the TPU kernels (bin l collects
// columns l, l+128, ...), so a thread owns the same bins for the whole run and
// keeps their running best in registers.
//
// Word types: f32 and bf16 rows are staged as f32 (bf16 x bf16 products are
// exact in f32); int8 rows are staged as packed int32 words of four values and
// multiplied with __dp4a into int32, which is exact in any order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cuvs_tpu_torch {

constexpr int kLanes = 128;                               // columns per slice
constexpr int kBQ = 64;                                   // query rows per block
constexpr int kTQ = 4;                                    // query rows per thread
constexpr int kTL = 8;                                    // lanes per thread
constexpr int kLaneThreads = kLanes / kTL;                // 16
constexpr int kThreads = (kBQ / kTQ) * kLaneThreads;      // 256
constexpr int kKW = 32;                                   // words staged per row
constexpr int kPad = kKW + 1;                             // odd stride: no bank conflicts

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Word = float;
  using Acc = float;
  static constexpr int kPerWord = 1;
};
template <>
struct Elem<__nv_bfloat16> {
  using Word = float;
  using Acc = float;
  static constexpr int kPerWord = 1;
};
template <>
struct Elem<int8_t> {
  using Word = int;
  using Acc = int;
  static constexpr int kPerWord = 4;
};

// Word w of a row of d elements, zero past the end of the row.
__device__ __forceinline__ float load_word(const float* row, int w, int d) {
  return w < d ? row[w] : 0.f;
}
__device__ __forceinline__ float load_word(const __nv_bfloat16* row, int w, int d) {
  return w < d ? __bfloat162float(row[w]) : 0.f;
}
__device__ __forceinline__ int load_word(const int8_t* row, int w, int d) {
  int e = 4 * w;
  if (e + 3 < d && (d & 3) == 0) return reinterpret_cast<const int*>(row)[w];
  int v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int byte = e + b < d ? static_cast<int>(static_cast<uint8_t>(row[e + b])) : 0;
    v |= byte << (8 * b);
  }
  return v;
}

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int a, int b, int acc) { return __dp4a(a, b, acc); }

// Stage words [w0, w0 + kKW) of `rows` rows into sm[rows][kPad]. row_ptr(r)
// gives row r's base pointer, or nullptr for a row that reads as zeros.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(typename Elem<T>::Word* sm, int rows, RowPtr row_ptr,
                                           int w0, int d) {
  using Word = typename Elem<T>::Word;
  for (int e = threadIdx.x; e < rows * kKW; e += kThreads) {
    int r = e / kKW, w = e % kKW;
    const T* p = row_ptr(r);
    sm[r * kPad + w] = p ? load_word(p, w0 + w, d) : Word(0);
  }
}

// acc[i][j] += <query row tq*kTQ+i, slice row tl+16*j> over the staged words.
template <typename Word, typename Acc>
__device__ __forceinline__ void tile_mac(const Word* qs, const Word* xs, int tq, int tl,
                                         Acc (&acc)[kTQ][kTL]) {
#pragma unroll 8
  for (int w = 0; w < kKW; ++w) {
    Word a[kTQ], b[kTL];
#pragma unroll
    for (int i = 0; i < kTQ; ++i) a[i] = qs[(tq * kTQ + i) * kPad + w];
#pragma unroll
    for (int j = 0; j < kTL; ++j) b[j] = xs[(tl + kLaneThreads * j) * kPad + w];
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int j = 0; j < kTL; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
  }
}

// Dot products of the block's query rows (element type TQ) with one 128-row
// slice (element type TX), over all of d. f32 and bf16 rows may be mixed:
// both stage as f32 words. Leaves the block synchronised with the staging
// buffers free.
template <typename TQ, typename TX, typename QRow, typename XRow>
__device__ __forceinline__ void slice_dots(typename Elem<TX>::Word* qs,
                                           typename Elem<TX>::Word* xs, QRow q_row, XRow x_row,
                                           int d, int tq, int tl,
                                           typename Elem<TX>::Acc (&acc)[kTQ][kTL]) {
  static_assert(std::is_same<typename Elem<TQ>::Word, typename Elem<TX>::Word>::value,
                "query and row words must match (int8 pairs only with int8)");
  using Acc = typename Elem<TX>::Acc;
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j) acc[i][j] = Acc(0);
  const int n_words = (d + Elem<TX>::kPerWord - 1) / Elem<TX>::kPerWord;
  for (int w0 = 0; w0 < n_words; w0 += kKW) {
    stage_rows<TQ>(qs, kBQ, q_row, w0, d);
    stage_rows<TX>(xs, kLanes, x_row, w0, d);
    __syncthreads();
    tile_mac(qs, xs, tq, tl, acc);
    __syncthreads();
  }
}

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

}  // namespace cuvs_tpu_torch
