// Fused brute-force distance + top-k kernels for Hopper (sm_90a).
//
// bf_topk_exact_kernel replaces cuvs_tpu/ops/bf_topk_pallas.py::_fused_kernel
// (exact=True): per (dataset tile, query block) the exact top-k of
// max(|q|^2 + |x|^2 - 2 q.x, 0) (L2) or -q.x (IP), ties to the lowest column,
// emitted as a [n_tiles, B, k] pool that the caller merges.
//
// bf_topk_approx_kernel replaces _approx_kernel (exact=False), float and int8
// paths: per (tile, query, lane bin) the best score q.x - pen over the tile's
// C = tile_n/128 strided slices, emitted as a [n_tiles, B, 128] pool of
// min-space values plus the uint8 winning slice.
//
// What bounds them on the card: the q.x products. At 1M x 128 and 4096
// queries that is 5.4e11 multiply-adds per batch, against 2.7e8 bytes of
// dataset; the dataset streams from L2/HBM once per query block. Both kernels
// are compute bound. This first version multiplies with plain FMA (f32, bf16
// widened to f32) or __dp4a (int8) from shared memory (tile_dot.cuh), which
// is exact for the int8 pools and IEEE f32 for ground truth (no TF32), and
// keeps the [B, tile] distance block out of device memory: each slice's
// scores are reduced in registers (approx) or in shared memory (exact) as
// soon as they are formed. Tensor-core MMA is the next step.
#include "tile_dot.cuh"

#include <climits>
#include <math.h>
#include <type_traits>

namespace cuvs_tpu_torch {

constexpr int kMaxExactK = 64;

// grid = (n_tiles, ceil(B / kBQ)); out_v/out_i are [n_tiles, B, k].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bf_topk_exact_kernel(const T* __restrict__ q, const T* __restrict__ x,
                     const float* __restrict__ qn, const float* __restrict__ xn, int B, int N,
                     int d, int k, int tile_n, int ip, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  using Word = typename Elem<T>::Word;
  using Acc = typename Elem<T>::Acc;
  // staging buffers and the per-slice distance block share one allocation:
  // the block synchronises between the two phases
  constexpr int kStageWords = (kBQ + kLanes) * kPad;
  constexpr int kDistWords = kBQ * (kLanes + 1);
  __shared__ __align__(16) char smem[4 * (kStageWords > kDistWords ? kStageWords : kDistWords)];
  Word* qs = reinterpret_cast<Word*>(smem);
  Word* xs = qs + kBQ * kPad;
  float* ds = reinterpret_cast<float*>(smem);

  const int t = blockIdx.x;
  const int qb = blockIdx.y * kBQ;
  const int tq = threadIdx.x / kLaneThreads, tl = threadIdx.x % kLaneThreads;
  const int base = t * tile_n;

  // running top-k of query qb + threadIdx.x (threads < kBQ), ascending by
  // (distance, column): columns arrive in increasing order, so a candidate
  // enters only when strictly smaller than the current k-th
  float lv[kMaxExactK];
  int li[kMaxExactK];
  for (int f = 0; f < k; ++f) {
    lv[f] = INFINITY;
    li[f] = 0;
  }

  auto q_row = [&](int r) -> const T* {
    int row = qb + r;
    return row < B ? q + static_cast<size_t>(row) * d : nullptr;
  };
  const int n_slices = (tile_n + kLanes - 1) / kLanes;
  for (int s = 0; s < n_slices; ++s) {
    const int c0 = s * kLanes;
    auto x_row = [&](int r) -> const T* {
      int col = base + c0 + r;
      return (c0 + r < tile_n && col < N) ? x + static_cast<size_t>(col) * d : nullptr;
    };
    Acc acc[kTQ][kTL];
    slice_dots<T, T>(qs, xs, q_row, x_row, d, tq, tl, acc);
#pragma unroll
    for (int i = 0; i < kTQ; ++i) {
      const int ql = tq * kTQ + i;
      const float qnv = qb + ql < B ? qn[qb + ql] : 0.f;
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        const int lane = tl + kLaneThreads * j;
        const int c = c0 + lane, col = base + c;
        float dist = INFINITY;  // padded rows and columns past the tile
        if (c < tile_n && col < N) {
          const float dot = static_cast<float>(acc[i][j]);
          dist = ip ? -dot : fmaxf(qnv + xn[col] - 2.0f * dot, 0.f);
        }
        ds[ql * (kLanes + 1) + lane] = dist;
      }
    }
    __syncthreads();
    if (threadIdx.x < kBQ) {
      const float* row = ds + threadIdx.x * (kLanes + 1);
      for (int c = 0; c < kLanes; ++c) {
        const float v = row[c];
        if (v < lv[k - 1]) {
          int p = k - 1;
          while (p > 0 && lv[p - 1] > v) {
            lv[p] = lv[p - 1];
            li[p] = li[p - 1];
            --p;
          }
          lv[p] = v;
          li[p] = base + c0 + c;
        }
      }
    }
    __syncthreads();
  }
  const int qg = qb + threadIdx.x;
  if (threadIdx.x < kBQ && qg < B) {
    const size_t o = (static_cast<size_t>(t) * B + qg) * k;
    for (int f = 0; f < k; ++f) {
      out_v[o + f] = lv[f];
      // the TPU kernel's masked argmax lands on column 0 once a tile has no
      // finite candidate left
      out_i[o + f] = lv[f] == INFINITY ? base : li[f];
    }
  }
}

// Score per (query, lane) running best. Float: score = dot - pen, strict >
// keeps the lowest slice. int8 chain: the same in int32. int8 key-pack: the
// slice id rides the low byte of (dot << 8) - pen', so a plain max suffices
// and the highest slice wins a tie, as in the TPU kernel.
constexpr int kFloatMode = 0, kChainMode = 1, kKeyPackMode = 2;

// grid = (n_tiles, ceil(B / kBQ)); pen is [n_tiles, C, 128] (float or int32);
// out_v/out_i are [n_tiles, B, 128].
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
bf_topk_approx_kernel(const T* __restrict__ q, const T* __restrict__ x,
                      const void* __restrict__ pen_raw, int B, int N, int d, int tile_n,
                      float* __restrict__ out_v, uint8_t* __restrict__ out_i) {
  using Word = typename Elem<T>::Word;
  using Acc = typename Elem<T>::Acc;
  using Best = typename std::conditional<kMode == kFloatMode, float, int>::type;
  __shared__ __align__(16) Word qs[kBQ * kPad];
  __shared__ __align__(16) Word xs[kLanes * kPad];
  const Best* pen = static_cast<const Best*>(pen_raw);

  const int t = blockIdx.x;
  const int qb = blockIdx.y * kBQ;
  const int tq = threadIdx.x / kLaneThreads, tl = threadIdx.x % kLaneThreads;
  const int C = tile_n / kLanes;
  const int base = t * tile_n;

  Best best[kTQ][kTL];
  int besti[kTQ][kTL];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      if constexpr (kMode == kFloatMode)
        best[i][j] = -INFINITY;
      else
        best[i][j] = INT_MIN;
      besti[i][j] = 0;
    }

  auto q_row = [&](int r) -> const T* {
    int row = qb + r;
    return row < B ? q + static_cast<size_t>(row) * d : nullptr;
  };
  for (int s = 0; s < C; ++s) {
    const int c0 = base + s * kLanes;
    auto x_row = [&](int r) -> const T* {
      return c0 + r < N ? x + static_cast<size_t>(c0 + r) * d : nullptr;
    };
    Acc acc[kTQ][kTL];
    slice_dots<T, T>(qs, xs, q_row, x_row, d, tq, tl, acc);
    const Best* pen_s = pen + (static_cast<size_t>(t) * C + s) * kLanes;
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        const Best p = pen_s[tl + kLaneThreads * j];
        if constexpr (kMode == kKeyPackMode) {
          const Best sc = static_cast<Best>(acc[i][j]) * 256 - p;
          best[i][j] = sc > best[i][j] ? sc : best[i][j];
        } else {
          const Best sc = static_cast<Best>(acc[i][j]) - p;
          if (sc > best[i][j]) {
            best[i][j] = sc;
            besti[i][j] = s;
          }
        }
      }
  }
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int qg = qb + tq * kTQ + i;
    if (qg >= B) continue;
    const size_t o = (static_cast<size_t>(t) * B + qg) * kLanes;
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      const int lane = tl + kLaneThreads * j;
      if constexpr (kMode == kKeyPackMode) {
        out_v[o + lane] = -static_cast<float>(static_cast<int>(best[i][j]) >> 8);
        out_i[o + lane] = static_cast<uint8_t>(static_cast<int>(best[i][j]) & 255);
      } else {
        out_v[o + lane] = -static_cast<float>(best[i][j]);
        out_i[o + lane] = static_cast<uint8_t>(besti[i][j]);
      }
    }
  }
}

}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch;

extern "C" int cuvs_bf_topk_exact(int dtype, const void* q, const void* x, const float* qn,
                                  const float* xn, int B, int N, int d, int k, int tile_n,
                                  int n_tiles, int ip, float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kMaxExactK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(n_tiles, (B + kBQ - 1) / kBQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      bf_topk_exact_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(x), qn, xn, B, N, d, k, tile_n,
          ip, out_v, out_i);
      break;
    case kBF16:
      bf_topk_exact_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), qn, xn, B,
          N, d, k, tile_n, ip, out_v, out_i);
      break;
    case kI8:
      bf_topk_exact_kernel<int8_t><<<grid, kThreads, 0, st>>>(
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(x), qn, xn, B, N, d, k,
          tile_n, ip, out_v, out_i);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cuvs_bf_topk_approx(int dtype, const void* q, const void* x, const void* pen,
                                   int B, int N, int d, int tile_n, int n_tiles, int key_pack,
                                   float* out_v, uint8_t* out_i, void* stream) {
  if (tile_n % kLanes || tile_n / kLanes > 256) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(n_tiles, (B + kBQ - 1) / kBQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      bf_topk_approx_kernel<float, kFloatMode><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(x), pen, B, N, d, tile_n,
          out_v, out_i);
      break;
    case kBF16:
      bf_topk_approx_kernel<__nv_bfloat16, kFloatMode><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), pen, B, N,
          d, tile_n, out_v, out_i);
      break;
    case kI8:
      if (key_pack)
        bf_topk_approx_kernel<int8_t, kKeyPackMode><<<grid, kThreads, 0, st>>>(
            static_cast<const int8_t*>(q), static_cast<const int8_t*>(x), pen, B, N, d, tile_n,
            out_v, out_i);
      else
        bf_topk_approx_kernel<int8_t, kChainMode><<<grid, kThreads, 0, st>>>(
            static_cast<const int8_t*>(q), static_cast<const int8_t*>(x), pen, B, N, d, tile_n,
            out_v, out_i);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
