// Fused quantized-code IVF scan (IVF-PQ and IVF-RaBitQ) for Hopper (sm_90a):
// pq_scan_kernel at cap <= 2 (the main path's k <= 64), the int8 table's
// scale pass and the C entry point, which sends cap 3-32 to pq_scan_deep.cu.
// The kernel replaces cuvs_tpu/ops/ivf_scan_pallas.py::_pq_scan_kernel; its
// design and what bounds it: pq_scan.cuh.
#include "pq_scan.cuh"

#include <algorithm>
#include <numeric>

namespace cuvs_tpu_torch {
namespace pq {

// Per-tile max |lut| over all M slots (int8 tables only), which fixes the
// tile's scale before any block quantizes its table. Block (t, eb) owns
// kAbsThreads quads of table entries of tile t (single entries where
// book % 4 != 0) for every slot: a thread holds the codebook values of its
// entries (kAbsL rows in registers) and walks the slots, 16 KB of query rows
// at a time in shared memory, with four accumulators, so nothing caps the
// block's occupancy. The sums are lut_quads'. absmax must be zeroed:
// non-negative floats order as their int bit patterns, so atomicMax on the
// bits takes the max.
constexpr int kAbsThreads = 256, kAbsL = 4;
constexpr size_t kAbsQBytes = 16 * 1024;  // query rows staged at once

__global__ void __launch_bounds__(kAbsThreads) pq_lut_absmax_kernel(Args a, int n_eb, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [chunk][dp]
  __shared__ float warp_max[kAbsThreads / 32];
  const int t = blockIdx.x / n_eb, eb = blockIdx.x % n_eb;
  int cc_lo;
  const int cc_hi = tile_slices(a, t, &cc_lo);
  if (cc_hi <= cc_lo) return;  // empty tile: no scale needed
  const int SB = a.S * a.book;
  const bool quad = a.book % 4 == 0;  // else one entry per thread
  const int e0 = (eb * kAbsThreads + static_cast<int>(threadIdx.x)) * (quad ? 4 : 1);
  const int j0 = (a.book_log2 >= 0 ? e0 >> a.book_log2 : e0 / a.book) * a.pq_len;
  const int L = e0 < SB ? max(0, min(a.pq_len, a.dp - j0)) : 0;
  auto load_c = [&](int l, float (&c)[4]) {
    const __nv_bfloat16* p = a.cb + static_cast<size_t>(j0 + l) * SB + e0;
    if (quad) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      c[0] = __uint_as_float(w.x << 16), c[1] = __uint_as_float(w.x & 0xffff0000u);
      c[2] = __uint_as_float(w.y << 16), c[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      c[0] = __bfloat162float(__ldg(p)), c[1] = c[2] = c[3] = 0.f;
    }
  };
  float creg[kAbsL][4];
#pragma unroll
  for (int l = 0; l < kAbsL; ++l)
    if (l < L) load_c(l, creg[l]);
  float mx = 0.f;
  for (int m0 = 0; m0 < a.M; m0 += chunk) {
    const int G = min(chunk, a.M - m0);
    __syncthreads();  // the last chunk's rows are read
    load_qrows(a, t, m0, G, qs);
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const float* qg = qs + g * a.dp + j0;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int l = 0; l < kAbsL; ++l) {
        if (l >= L) break;
        const float qv = qg[l];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(qv, creg[l][k], acc[k]);
      }
      for (int l = kAbsL; l < L; ++l) {  // rows past the registers: from L1
        float c[4];
        load_c(l, c);
        const float qv = qg[l];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(qv, c[k], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) mx = fmaxf(mx, fabsf(acc[k]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kAbsThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(a.absmax) + t, __float_as_int(mx));
  }
}

// Slots per scan block at cap <= 2: two blocks per SM where at least 4 slots
// fit half the shared memory (RaBitQ: 8 slots; PQ's int8 table: 4): the
// second block's scan hides the first one's table build. Else the most slots
// (8, 4, 2, 1) that fit, one block per SM (PQ's bf16 table: 4 slots). Never
// wider than the tile needs. slots = 0 if none fits.
struct Plan {
  int slots;
  bool two;  // two blocks per SM
};

inline Plan plan(const Args& a) {
  for (int two = 1; two >= 0; --two)
    for (int G = kMaxGroups; G >= (two ? 4 : 1); G /= 2) {
      if (G > 1 && G / 2 >= a.M) continue;
      if (scan_smem(G, a) <= smem_limit(two == 1)) return {G, two == 1};
    }
  return {0, false};
}

// Bins two deep (cap 1 writes the first level).
template <typename T, int kSlots>
cudaError_t launch_shallow(const Plan& p, int n_tiles, cudaStream_t st, const Args& a) {
  // the main path's shapes: PQ 8-bit codes (4 slots; bf16 table: one block
  // per SM, int8 table: two) and RaBitQ 3-bit codes (bf16, 8 slots, two)
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  if constexpr (kSlots == 4)
    if (a.bits == 8 && a.book == 256 && p.two == kInt8)
      return launch_scan_kernel(pq_scan_kernel<T, 4, 2, 8, kInt8 ? 2 : 1>, 4, n_tiles, st, a);
  if constexpr (kSlots == 8 && !kInt8)
    if (a.bits == 3 && a.book == 8 && p.two)
      return launch_scan_kernel(pq_scan_kernel<T, 8, 2, 3, 2>, 8, n_tiles, st, a);
  return launch_scan_kernel(pq_scan_kernel<T, kSlots, 2, 0, 1>, kSlots, n_tiles, st, a);
}

template <typename T>
cudaError_t launch_slots(const Plan& p, int n_tiles, cudaStream_t st, const Args& a) {
  switch (p.slots) {
    case 8: return launch_shallow<T, 8>(p, n_tiles, st, a);
    case 4: return launch_shallow<T, 4>(p, n_tiles, st, a);
    case 2: return launch_shallow<T, 2>(p, n_tiles, st, a);
    default: return launch_shallow<T, 1>(p, n_tiles, st, a);
  }
}

}  // namespace pq
}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch::pq;

static int words_per_row(int S, int bits) {
  return static_cast<int>((static_cast<long long>(S) * bits + 31) / 32);
}

extern "C" int cuvs_pq_scan(const void* codes, int Sw, int n_pad, const float* norms, int n_norms,
                            const float* fr, const void* q, const void* cb, const void* ctile,
                            const int* qidx, const int* al, const int* lo, const int* sizes,
                            int n_tiles, int M, int dp, int S, int book, int bits, int pq_len,
                            int W, int cap, int rabitq, int ip, int use_pen, int int8_mode,
                            float* absmax, float* out_v, uint8_t* out_i, void* stream) {
  if (cap < 1 || cap > kMaxCap || W % kLanes || W / kLanes > 256 || bits < 1 || bits > 32 ||
      book < 1 || S < 1 || pq_len < 1 || (rabitq && fr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = words_per_row(S, bits);
  if (nw > Sw) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n_pad % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  Args a{static_cast<const uint32_t*>(codes), Sw, n_pad, norms, n_norms, fr,
         static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cb),
         static_cast<const __nv_bfloat16*>(ctile), qidx, al, lo, sizes,
         nw, M, dp, S, book, bits, pq_len, W, cap, rabitq, ip, use_pen, int8_mode, vec,
         (book & (book - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(book)) : -1,
         32 / std::gcd(32, bits), bits / std::gcd(32, bits), absmax, out_v, out_i};
  // no block of the plan fits: the error, never another way to the pool
  const Plan p = cap <= 2 ? plan(a) : Plan{};
  const DeepPlan deep = cap <= 2 ? DeepPlan{} : plan_deep(a);
  if (cap <= 2 ? p.slots < 1 : deep.slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_mode) {
    const int per_block = kAbsThreads * (book % 4 == 0 ? 4 : 1);
    const int n_eb = (S * book + per_block - 1) / per_block;
    const size_t row = static_cast<size_t>(dp) * sizeof(float);
    const int chunk = static_cast<int>(std::max<size_t>(1, std::min<size_t>(M, kAbsQBytes / row)));
    if (chunk * row > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = launch(pq_lut_absmax_kernel, dim3(n_tiles * n_eb), dim3(kAbsThreads),
                                 chunk * row, st, a, n_eb, chunk);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (cap > 2) return static_cast<int>(launch_deep(deep, n_tiles, st, a));
  const cudaError_t e = int8_mode ? launch_slots<int8_t>(p, n_tiles, st, a)
                                  : launch_slots<__nv_bfloat16>(p, n_tiles, st, a);
  return static_cast<int>(e);
}
