// Fused quantized-code IVF scan (IVF-PQ and IVF-RaBitQ) for Hopper (sm_90a).
//
// pq_scan_kernel replaces cuvs_tpu/ops/ivf_scan_pallas.py::_pq_scan_kernel
// (via fused_pq_scan). One pair tile from group_pairs_tiled holds M query
// slots that all probe one list. For each slot the kernel builds the ADC
// lookup table lut[s*book + c] = <q'_slot, cb_t[:, s*book + c]> (q' the
// slot's bf16 rotated query, minus the tile's rotated center for PQ-L2; a
// zero row for an empty slot), rounds it to bf16 or quantizes it to int8 with
// one scale per tile, then scores every row of the tile's W-row window of
// packed codes as dots = sum_s lut[s*book + code_s] and keeps the best `cap`
// scores per (slot, strided lane bin) by the TPU kernel's insertion chain
// (strict >). Epilogues: "pq" v = dots - pen (pen = 0.5*norm for L2, 0 for
// IP, the norm channel itself for IP with a filter penalty); "rabitq"
// v = -(fa + fr*dots). Rows outside [lo, lo + size) score -inf. Output:
// f * best as [n_tiles, M, cap*128] f32 plus the uint8 128-slice id of each
// entry, f = -2 (pq L2) or -1 (pq IP, rabitq).
//
// What bounds it on the card: the table lookups. At 1M rows, 4096 queries,
// 50 probes and pq_dim 64 a batch reads about 3.3e10 entries, one per
// (slot, row, subspace), at random within each subspace's `book` entries.
// The TPU kernel turns the lookups into one-hot matmuls because gathers are
// slow there; on Hopper a shared-memory gather is the natural form, so each
// slot's whole table lives in shared memory (32 KB in bf16 at 64 x 256) and
// one 128-thread group per slot walks the window, one thread per lane bin
// and one 128-row slice after another in order, as csrc/ivf_scan.cu does:
// that keeps the insertion order, and so the ties, the TPU kernel's. A block
// holds up to 8 slots (as many tables as fit 227 KB of shared memory) and
// builds their tables together, reading each codebook column once. Only the
// pq_len nonzero rows of each column of the block-diagonal cb_t are read.
// Random lookups into a 256-entry row of the table meet shared-memory bank
// conflicts; a layout that avoids them is later work. The window's code words
// are the other cost: read one at a time by each thread, every word would be
// a device-memory round trip the thread waits for. So the block stages each
// 128-row slice of the window's words in shared memory first, all of its
// threads loading at once, coalesced from the transposed [Sw, n_pad] layout,
// and its slot groups then decode the slice from there through a 64-bit bit
// buffer that handles codes which straddle two words. The int8 table's scale
// is the max |lut| over all M slots of a tile, so a first small kernel
// (pq_lut_absmax_kernel) computes it per tile. Sums: the table entries are
// f32 sums of exact bf16 products in row order; dots sum s = 0..S-1 in order
// (f32 for the bf16 table, int32 then times the scale for int8); the epilogue
// uses __fmul_rn/__fadd_rn so no fused multiply-add changes a rounding. A
// later version may use mma for the table and a register-blocked scan; this
// one is simple and right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cuvs_tpu_torch {
namespace pq {

constexpr int kLanes = 128;      // threads per slot group = lane bins
constexpr int kMaxGroups = 8;    // slots per block
constexpr int kMaxCap = 32;
constexpr int kSmemMax = 232448;  // 227 KB of dynamic shared memory per block

struct Args {
  const uint32_t* codes;  // [Sw, n_pad] packed words
  int Sw, n_pad;
  const float* norms;  // pq: decoded norms (or IP filter penalty); rabitq: fa
  int n_norms;
  const float* fr;  // rabitq: f_rescale, else unused
  const __nv_bfloat16* q;      // [nq, dp] rotated queries
  const __nv_bfloat16* cb;     // [dp, S*book] transposed block-diagonal codebook
  const __nv_bfloat16* ctile;  // [n_tiles, dp] rotated center per tile
  const int* qidx;             // [n_tiles, M]
  const int* al;
  const int* lo;
  const int* sizes;
  int nw;  // word rows holding a row's S codes: ceil(S * bits / 32)
  int M, dp, S, book, bits, pq_len, W, cap;
  int rabitq, ip, use_pen, int8_mode;
  float* absmax;  // [n_tiles] max |lut| per tile (int8 mode)
  float* out_v;
  uint8_t* out_i;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

__device__ __forceinline__ int tile_slices(const Args& a, int t, int* cc_lo) {
  const int l = a.lo[t], h = l + a.sizes[t];
  *cc_lo = h > l ? l / kLanes : 0;
  return h > l ? min((h + kLanes - 1) / kLanes, a.W / kLanes) : 0;
}

// Query rows of the block's slots into qs[G][dp] as f32 (bf16 values): the
// slot's row, or zeros for an empty slot, minus the tile's center in mode pq
// with L2 (a bf16 - bf16 subtraction rounded to bf16).
__device__ void load_qrows(const Args& a, int t, int m0, int G, float* qs) {
  const bool center = !a.rabitq && !a.ip;
  for (int e = threadIdx.x; e < G * a.dp; e += blockDim.x) {
    const int g = e / a.dp, j = e % a.dp;
    const int m = m0 + g;
    const int qi = m < a.M ? a.qidx[static_cast<size_t>(t) * a.M + m] : -1;
    float f = qi >= 0 ? __bfloat162float(a.q[static_cast<size_t>(qi) * a.dp + j]) : 0.f;
    if (center) {
      const float c = __bfloat162float(a.ctile[static_cast<size_t>(t) * a.dp + j]);
      f = __bfloat162float(__float2bfloat16_rn(__fsub_rn(f, c)));
    }
    qs[e] = f;
  }
}

// Table entry e of every slot of the block: acc[g] = sum over the column's
// pq_len nonzero rows of qs[g][j] * cb[j][e], in row order. Each product of
// two bf16 values is exact in f32. The codebook values are read kRows at a
// time, so their loads are in flight together.
__device__ __forceinline__ void lut_entries(const Args& a, const float* qs, int G, int e,
                                            float (&acc)[kMaxGroups]) {
  constexpr int kRows = 4;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) acc[g] = 0.f;
  const int SB = a.S * a.book;
  const int j0 = (e / a.book) * a.pq_len;
  const int L = max(0, min(a.pq_len, a.dp - j0));
  for (int l0 = 0; l0 < L; l0 += kRows) {
    float c[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      c[u] = l0 + u < L ? __bfloat162float(__ldg(a.cb + static_cast<size_t>(j0 + l0 + u) * SB + e))
                        : 0.f;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (l0 + u >= L) break;
      const int j = j0 + l0 + u;
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
        if (g < G) acc[g] = fmaf(qs[g * a.dp + j], c[u], acc[g]);
    }
  }
}

// Per-tile max |lut| over all M slots (int8 tables only). grid = (n_tiles,
// ceil(M / G)); absmax must be zeroed: non-negative floats order as their
// int bit patterns, so atomicMax on the bits takes the max.
__global__ void __launch_bounds__(kLanes* kMaxGroups) pq_lut_absmax_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __shared__ float warp_max[kLanes * kMaxGroups / 32];
  const int G = blockDim.x / kLanes;
  const int t = blockIdx.x, m0 = blockIdx.y * G;
  int cc_lo;
  const int cc_hi = tile_slices(a, t, &cc_lo);
  if (cc_hi <= cc_lo) return;  // empty tile: no scale needed
  load_qrows(a, t, m0, G, qs);
  __syncthreads();
  const int SB = a.S * a.book;
  const int live = min(G, a.M - m0);
  float mx = 0.f;
  for (int e = threadIdx.x; e < SB; e += blockDim.x) {
    float acc[kMaxGroups];
    lut_entries(a, qs, live, e, acc);
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (g < live) mx = fmaxf(mx, fabsf(acc[g]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(a.absmax) + t, __float_as_int(mx));
  }
}

// kCap > 0: compile-time depth, state in registers. kCap == 0: runtime depth
// cap <= kMaxCap, state in thread-local memory. grid = (n_tiles, ceil(M / G)),
// G*128 threads; thread (g, lane) owns slot m0 + g and lane bin `lane`.
// Shared memory: the slots' query rows, one slice of code words, the tables.
template <int kCap>
__global__ void __launch_bounds__(kLanes* kMaxGroups, 2) pq_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kDepth = kCap > 0 ? kCap : kMaxCap;
  const int cap = kCap > 0 ? kCap : a.cap;
  const int G = blockDim.x / kLanes;
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int t = blockIdx.x, m0 = blockIdx.y * G, m = m0 + g;
  const bool slot = m < a.M;  // this thread's slot exists (it still stages words)
  const int SB = a.S * a.book;
  const size_t lut_stride = align16(static_cast<size_t>(SB) * (a.int8_mode ? 1 : 2));
  float* qs = reinterpret_cast<float*>(smem);
  uint32_t* sw = reinterpret_cast<uint32_t*>(
      smem + align16(static_cast<size_t>(G) * a.dp * sizeof(float)));
  unsigned char* luts =
      reinterpret_cast<unsigned char*>(sw) + align16(static_cast<size_t>(a.nw) * kLanes * 4);
  const float f = (a.ip || a.rabitq) ? -1.f : -2.f;

  float best[kDepth];
  int bidx[kDepth];
  for (int r = 0; r < cap; ++r) {
    best[r] = -INFINITY;
    bidx[r] = 0;
  }
  int cc_lo;
  const int cc_hi = tile_slices(a, t, &cc_lo);
  if (cc_hi > cc_lo) {  // uniform in the block
    const int live = min(G, a.M - m0);
    load_qrows(a, t, m0, G, qs);
    __syncthreads();
    const float ls = a.int8_mode ? __fdiv_rn(fmaxf(a.absmax[t], 1e-30f), 127.f) : 1.f;
#pragma unroll 2
    for (int e = threadIdx.x; e < SB; e += blockDim.x) {
      float acc[kMaxGroups];
      lut_entries(a, qs, live, e, acc);
#pragma unroll
      for (int gg = 0; gg < kMaxGroups; ++gg) {
        if (gg >= live) continue;
        unsigned char* lut = luts + gg * lut_stride;
        if (a.int8_mode)  // |lut/ls| <= 127 by construction: no clip needed
          reinterpret_cast<int8_t*>(lut)[e] = static_cast<int8_t>(rintf(__fdiv_rn(acc[gg], ls)));
        else
          reinterpret_cast<__nv_bfloat16*>(lut)[e] = __float2bfloat16_rn(acc[gg]);
      }
    }

    const int8_t* lut8 = reinterpret_cast<const int8_t*>(luts + g * lut_stride);
    const __nv_bfloat16* lut16 = reinterpret_cast<const __nv_bfloat16*>(luts + g * lut_stride);
    const uint64_t mask = a.bits >= 32 ? 0xffffffffull : ((1ull << a.bits) - 1);
    const int base = a.al[t];
    const int l = a.lo[t], h = l + a.sizes[t];
    for (int cc = cc_lo; cc < cc_hi; ++cc) {
      // stage the slice's words: sw[i * 128 + r] = word i of window row
      // cc*128 + r (codes[i * n_pad + row]); the barrier before it also
      // publishes the tables on the first slice
      __syncthreads();
      for (int e = threadIdx.x; e < a.nw * kLanes; e += blockDim.x) {
        const int row = base + cc * kLanes + e % kLanes;
        sw[e] = row < a.n_pad ? __ldg(a.codes + static_cast<size_t>(e / kLanes) * a.n_pad + row)
                              : 0u;
      }
      __syncthreads();
      const int pos = cc * kLanes + lane;
      if (!slot || pos < l || pos >= h) continue;  // outside the list: -inf, never inserted
      const int row = base + pos;
      // decode through a 64-bit bit buffer: a code that straddles two words
      // takes its high bits from the next one
      uint64_t buf = 0;
      int have = 0, wi = 0;
      float accf = 0.f;
      int acci = 0;
      for (int s = 0; s < a.S; ++s) {
        if (have < a.bits) {
          buf |= static_cast<uint64_t>(sw[wi * kLanes + lane]) << have;
          have += 32;
          ++wi;
        }
        const int code = static_cast<int>(buf & mask);
        buf >>= a.bits;
        have -= a.bits;
        if (code >= a.book) continue;  // an out-of-book code selects nothing
        const int e = s * a.book + code;
        if (a.int8_mode)
          acci += lut8[e];
        else
          accf = __fadd_rn(accf, __bfloat162float(lut16[e]));
      }
      const float dots = a.int8_mode ? __fmul_rn(static_cast<float>(acci), ls) : accf;
      const float nrm = row < a.n_norms ? a.norms[row] : 0.f;
      float v;
      if (a.rabitq) {
        const float frv = row < a.n_norms ? a.fr[row] : 0.f;
        v = -__fadd_rn(nrm, __fmul_rn(frv, dots));
      } else {
        const float pen = a.ip ? (a.use_pen ? nrm : 0.f) : __fmul_rn(nrm, 0.5f);
        v = __fsub_rn(dots, pen);
      }
      if (!(v > best[cap - 1])) continue;  // below the whole bin: no change
      int vi = cc;
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
  }
  if (!slot) return;
  const size_t o = (static_cast<size_t>(t) * a.M + m) * (cap * kLanes);
  for (int r = 0; r < cap; ++r) {
    a.out_v[o + r * kLanes + lane] = f * best[r];
    a.out_i[o + r * kLanes + lane] = static_cast<uint8_t>(bidx[r]);
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t st, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, block, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace pq
}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch::pq;

static int words_per_row(int S, int bits) {
  return static_cast<int>((static_cast<long long>(S) * bits + 31) / 32);
}

// Slots per block for a table of S*book entries: as many as fit the shared
// memory beside one slice of code words, at most 8, evened out over the
// tile's M slots; 0 if one does not fit.
static int pq_scan_slots(int M, int dp, int S, int book, int bits, int int8_mode) {
  const size_t per_slot =
      align16(static_cast<size_t>(S) * book * (int8_mode ? 1 : 2)) + static_cast<size_t>(dp) * 4;
  // one slice of words, + 16 for the alignment of the query rows
  const size_t fixed = align16(static_cast<size_t>(words_per_row(S, bits)) * kLanes * 4) + 16;
  if (fixed >= static_cast<size_t>(kSmemMax)) return 0;
  int G = static_cast<int>((kSmemMax - fixed) / per_slot);
  G = G < kMaxGroups ? G : kMaxGroups;
  G = G < M ? G : M;
  if (G < 1) return 0;
  const int nb = (M + G - 1) / G;
  return (M + nb - 1) / nb;
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
  const int G = pq_scan_slots(M, dp, S, book, bits, int8_mode);
  const int nw = words_per_row(S, bits);
  if (G < 1 || nw > Sw) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint32_t*>(codes), Sw, n_pad, norms, n_norms, fr,
         static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cb),
         static_cast<const __nv_bfloat16*>(ctile), qidx, al, lo, sizes,
         nw, M, dp, S, book, bits, pq_len, W, cap, rabitq, ip, use_pen, int8_mode,
         absmax, out_v, out_i};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, (M + G - 1) / G), block(G * kLanes);
  const size_t q_bytes = align16(static_cast<size_t>(G) * dp * sizeof(float));
  if (int8_mode) {
    const cudaError_t e = launch(pq_lut_absmax_kernel, grid, block, q_bytes, st, a);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = q_bytes + align16(static_cast<size_t>(nw) * kLanes * 4) +
                      G * align16(static_cast<size_t>(S) * book * (int8_mode ? 1 : 2));
  const cudaError_t e = cap == 2 ? launch(pq_scan_kernel<2>, grid, block, smem, st, a)
                                 : launch(pq_scan_kernel<0>, grid, block, smem, st, a);
  return static_cast<int>(e);
}
