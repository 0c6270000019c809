// Fused IVF cluster-major scan for Hopper (sm_90a).
//
// ivf_scan_kernel replaces cuvs_tpu/ops/ivf_scan_pallas.py::_scan_kernel
// (via fused_ivf_scan). One pair tile from group_pairs_tiled holds M query
// slots that all probe one list; the tile scores its slots against the W-row
// window of sorted rows starting at al[t], with penalty 0.5*|y|^2/scale on
// window positions [lo, lo + size) and +inf elsewhere, and keeps the best
// `cap` scores per (slot, strided lane bin) by the TPU kernel's insertion
// chain (strict >). Output: f * best as [n_tiles, M, cap*128] f32 plus the
// uint8 128-slice id of each entry, f = -2*scale (L2) or -scale (IP).
//
// What bounds it on the card: the slot x window products (at 1M x 128,
// 4096 queries, 64 probes: about 1e11 multiply-adds per batch) and, per
// element, the cap-deep insertion. The window is re-read by each 64-slot
// block of the tile, from L2. This first version multiplies with FMA or
// __dp4a from shared memory (tile_dot.cuh) and keeps the insertion state in
// registers (cap <= 2) or thread-local memory (3 <= cap <= 32). It reads
// query rows by plain index through qidx (the TPU kernel's one-hot matmul
// gather is a TPU workaround), reads norms by plain index into the flat
// sorted_norms, and skips the window slices that hold no row of the list,
// which changes no output: every score there is -inf and never inserted.
#include "tile_dot.cuh"

#include <math.h>

namespace cuvs_tpu_torch {

constexpr int kMaxCap = 32;

// T: row type, TQ: query type (f32 and bf16 mix; int8 pairs with int8).
// kCap > 0: compile-time depth, state in registers. kCap == 0: runtime depth
// cap <= kMaxCap, state in thread-local memory.
// grid = (n_tiles, ceil(M / kBQ)).
template <typename T, typename TQ, int kCap>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const T* __restrict__ data, const float* __restrict__ norms,
                const TQ* __restrict__ q, const int* __restrict__ qidx,
                const int* __restrict__ al, const int* __restrict__ lo,
                const int* __restrict__ sizes, const float* __restrict__ scale_p, int M, int dp,
                int n_rows, int W, int cap_rt, int ip, float* __restrict__ out_v,
                uint8_t* __restrict__ out_i) {
  using Word = typename Elem<T>::Word;
  using Acc = typename Elem<T>::Acc;
  constexpr int kDepth = kCap > 0 ? kCap : kMaxCap;
  const int cap = kCap > 0 ? kCap : cap_rt;
  __shared__ __align__(16) Word qs[kBQ * kPad];
  __shared__ __align__(16) Word xs[kLanes * kPad];

  const int t = blockIdx.x;
  const int m0 = blockIdx.y * kBQ;
  const int tq = threadIdx.x / kLaneThreads, tl = threadIdx.x % kLaneThreads;
  const float scale = *scale_p;
  const float half_inv = 0.5f / scale;
  const int a = al[t];
  const int l = lo[t];
  const int h = l + sizes[t];

  float best[kDepth][kTQ][kTL];
  int bidx[kDepth][kTQ][kTL];
  for (int r = 0; r < cap; ++r)
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        best[r][i][j] = -INFINITY;
        bidx[r][i][j] = 0;
      }

  auto q_row = [&](int r) -> const TQ* {
    const int m = m0 + r;
    const int qi = m < M ? qidx[static_cast<size_t>(t) * M + m] : -1;
    return qi >= 0 ? q + static_cast<size_t>(qi) * dp : nullptr;
  };
  // slices [cc_lo, cc_hi) cover the list's window positions [l, h)
  const int cc_lo = h > l ? l / kLanes : 0;
  const int cc_hi = h > l ? min((h + kLanes - 1) / kLanes, W / kLanes) : 0;
  for (int cc = cc_lo; cc < cc_hi; ++cc) {
    const int p0 = cc * kLanes;
    auto x_row = [&](int r) -> const T* {
      const int row = a + p0 + r;
      return (row >= 0 && row < n_rows) ? data + static_cast<size_t>(row) * dp : nullptr;
    };
    Acc acc[kTQ][kTL];
    slice_dots<TQ, T>(qs, xs, q_row, x_row, dp, tq, tl, acc);
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      const int pos = p0 + tl + kLaneThreads * j;
      const bool valid = pos >= l && pos < h;
      // explicit roundings: no fused multiply-add, so the int8 pools are
      // bit-identical to the plain version's
      const float pen = valid ? (ip ? 0.f : __fmul_rn(norms[a + pos], half_inv)) : INFINITY;
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        float v = __fsub_rn(static_cast<float>(acc[i][j]), pen);
        if (!(v > best[cap - 1][i][j])) continue;  // below the whole bin: no change
        int vi = cc;
        for (int r = 0; r < cap; ++r) {
          if (v > best[r][i][j]) {
            const float ob = best[r][i][j];
            const int oi = bidx[r][i][j];
            best[r][i][j] = v;
            bidx[r][i][j] = vi;
            v = ob;
            vi = oi;
          }
        }
      }
    }
  }
  const float f = ip ? -scale : -2.0f * scale;
  const int F = cap * kLanes;
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int m = m0 + tq * kTQ + i;
    if (m >= M) continue;
    const size_t o = (static_cast<size_t>(t) * M + m) * F;
    for (int r = 0; r < cap; ++r)
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        const int lane = tl + kLaneThreads * j;
        out_v[o + r * kLanes + lane] = f * best[r][i][j];
        out_i[o + r * kLanes + lane] = static_cast<uint8_t>(bidx[r][i][j]);
      }
  }
}

template <typename T, typename TQ>
void launch_ivf_scan(dim3 grid, cudaStream_t st, const void* data, const float* norms,
                     const void* q, const int* qidx, const int* al, const int* lo,
                     const int* sizes, const float* scale, int M, int dp, int n_rows, int W,
                     int cap, int ip, float* out_v, uint8_t* out_i) {
  const T* d = static_cast<const T*>(data);
  const TQ* qq = static_cast<const TQ*>(q);
  if (cap == 2)
    ivf_scan_kernel<T, TQ, 2><<<grid, kThreads, 0, st>>>(d, norms, qq, qidx, al, lo, sizes, scale,
                                                          M, dp, n_rows, W, cap, ip, out_v, out_i);
  else
    ivf_scan_kernel<T, TQ, 0><<<grid, kThreads, 0, st>>>(d, norms, qq, qidx, al, lo, sizes, scale,
                                                          M, dp, n_rows, W, cap, ip, out_v, out_i);
}

}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch;

extern "C" int cuvs_ivf_scan(int dtype, int qdtype, const void* data, const float* norms,
                             const void* q, const int* qidx, const int* al, const int* lo,
                             const int* sizes, const float* scale, int n_tiles, int M, int dp,
                             int n_rows, int W, int cap, int ip, float* out_v, uint8_t* out_i,
                             void* stream) {
  if (cap < 1 || cap > kMaxCap || W % kLanes || W / kLanes > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(n_tiles, (M + kBQ - 1) / kBQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    launch(grid, st, data, norms, q, qidx, al, lo, sizes, scale, M, dp, n_rows, W, cap, ip, out_v,
           out_i);
  };
  if (dtype == kI8 && qdtype == kI8)
    args(launch_ivf_scan<int8_t, int8_t>);
  else if (dtype == kF32 && qdtype == kF32)
    args(launch_ivf_scan<float, float>);
  else if (dtype == kF32 && qdtype == kBF16)
    args(launch_ivf_scan<float, __nv_bfloat16>);
  else if (dtype == kBF16 && qdtype == kF32)
    args(launch_ivf_scan<__nv_bfloat16, float>);
  else if (dtype == kBF16 && qdtype == kBF16)
    args(launch_ivf_scan<__nv_bfloat16, __nv_bfloat16>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
