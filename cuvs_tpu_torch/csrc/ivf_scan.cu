// Fused IVF cluster-major scan for Hopper (sm_90a).
//
// ivf_scan replaces cuvs_tpu/ops/ivf_scan_pallas.py::_scan_kernel (via
// fused_ivf_scan). One pair tile from group_pairs_tiled holds M query slots
// that all probe one list; the tile scores its slots against the W-row window
// of sorted rows starting at al[t], with penalty 0.5*|y|^2/scale on window
// positions [lo, lo + size) and +inf elsewhere, and keeps the best `cap`
// scores per (slot, strided lane bin) by the TPU kernel's insertion chain
// (strict >). Output: f * best as [n_tiles, M, cap*128] f32 plus the uint8
// 128-slice id of each entry, f = -2*scale (L2) or -scale (IP).
//
// What bounds it on the card: at 1M x 128, 4096 queries, 64 probes the
// products are about 3.4e10 operations (0.03 ms of bf16 tensor-core time),
// and the least bytes (rows read once, pools written once) are about 0.9 GB,
// 0.28 ms, most of it the [tiles, M, cap*128] pool. The work per tile is
// short: a list of ~500 rows is 4-5 slices of 128 rows. So what bounds the
// kernel is latency and issue: gathering the tile's query rows, filling the
// pipeline, and the per-element epilogue. The first version multiplied with
// FMA from padded shared memory between two barriers per 32-word chunk.
//
// The design (bf16 and int8 rows, ivf_scan_mma_kernel):
//  * The brute-force kernels' tensor-core tile (mma_tile.cuh: mma.sync
//    m16n8k16 bf16 / m16n8k32 s8, ldmatrix from XOR-swizzled shared memory):
//    a block owns 64 slots of a tile (8 warps of 32 slots x 32 lanes); the
//    blocks of a tile are adjacent in the grid and share its window in L2.
//    The slots' query rows are gathered through qidx into the resident query
//    block (an empty slot is a row of zeros); the window's slices
//    [cc_lo, cc_hi) stream through the cp.async ring, two 128-byte chunks per
//    barrier, up to three groups in flight, so the loads of the next slices
//    overlap the products and the epilogue.
//  * The epilogue stays in registers: after each slice's products every
//    accumulator element is one (slot, lane bin), owned by one thread for the
//    whole window, which subtracts its penalty and runs the cap-deep chain in
//    slice order: the TPU kernel's ties, exactly. State for cap 2 (value and
//    slice, two deep, 32 elements) sits beside the 32 accumulators within the
//    255 registers of a 256-thread block.
//  * int8 rows accumulate exactly in int32, so their pools are bit-identical
//    to the plain version's; bf16 rows sum the same exact products in the
//    tensor cores' order (rtol 1e-4 / atol 1e-3 of the plain version).
//  * f32 rows and f32 queries (not on the main path) keep the first version's
//    FMA loop (tile_dot.cuh, ivf_scan_fma_kernel).
// Both read norms by plain index into the flat sorted_norms and skip the
// window slices that hold no row of the list, which changes no output: every
// score there is -inf and never inserted.
#include "mma_tile.cuh"
#include "tile_dot.cuh"

#include <math.h>

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

// bf16 or int8 rows and queries on tensor cores. kCap > 0: compile-time
// depth, state in registers; kCap == 0: runtime depth cap <= kMaxCap in
// thread-local memory. n_tiles * ceil(M / kBQ) blocks.
template <typename T, int kWM, int kCap>
__global__ void __launch_bounds__(MmaTile<T, kWM>::kThreads, 1)
ivf_scan_mma_kernel(const T* __restrict__ data, const float* __restrict__ norms,
                    const T* __restrict__ q, const int* __restrict__ qidx,
                    const int* __restrict__ al, const int* __restrict__ lo,
                    const int* __restrict__ sizes, const float* __restrict__ scale_p, int M,
                    int dp, int n_rows, int W, int cap_rt, int ip, int vec,
                    float* __restrict__ out_v, uint8_t* __restrict__ out_i) {
  using Tile = MmaTile<T, kWM>;
  using Acc = typename Tile::Acc;
  constexpr int kBQ = Tile::kBQ;
  constexpr int kDepth = kCap > 0 ? kCap : kMaxCap;
  const int cap = kCap > 0 ? kCap : cap_rt;
  extern __shared__ __align__(128) char smem[];
  const int nk = Tile::n_chunks_k(dp);
  char* qs = smem;
  char* ring = qs + static_cast<size_t>(kBQ) * nk * kChunkBytes;

  const int n_qb = (M + kBQ - 1) / kBQ;  // a tile's blocks are adjacent
  const int t = blockIdx.x / n_qb, m0 = blockIdx.x % n_qb * kBQ;
  const float scale = *scale_p;
  const float half_inv = 0.5f / scale;
  const int a = al[t], l = lo[t], h = l + sizes[t];

  float best[2][4][4][kDepth];
  int bidx[2][4][4][kDepth];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        for (int r = 0; r < cap; ++r) {
          best[mi][ni][e][r] = -INFINITY;
          bidx[mi][ni][e][r] = 0;
        }
  // slices [cc_lo, cc_hi) cover the list's window positions [l, h)
  const int cc_lo = h > l ? l / kSliceRows : 0;
  const int cc_hi = h > l ? min((h + kSliceRows - 1) / kSliceRows, W / kSliceRows) : 0;
  if (cc_hi > cc_lo) {  // uniform in the block
    Tile::stage_query_rows(qs, [&](int r) -> const T* {
      const int m = m0 + r;
      const int qi = m < M ? qidx[static_cast<size_t>(t) * M + m] : -1;
      return qi >= 0 ? q + static_cast<size_t>(qi) * dp : nullptr;
    }, dp, vec);
    const T* rows[Tile::kRowsPerThread];
    Acc acc[2][4][4];
    run_chunks<Tile::kStages, Tile::kGroup>(
        (cc_hi - cc_lo) * nk,
        [&](int j, int slot) {
          if (j % nk == 0) {
            const int r0 = a + (cc_lo + j / nk) * kSliceRows;
            Tile::rows(rows, [&](int r) -> const T* {
              return r0 + r < n_rows ? data + static_cast<size_t>(r0 + r) * dp : nullptr;
            });
          }
          Tile::stage_rows(ring + slot * Tile::kTileBytes, rows, j % nk, dp, vec);
        },
        [&](int i, int slot) {
          const int kc = i % nk, cc = cc_lo + i / nk;
          if (kc == 0) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
          }
          Tile::compute(qs + static_cast<size_t>(kc) * kBQ * kChunkBytes,
                        ring + slot * Tile::kTileBytes, acc);
          if (kc != nk - 1) return;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float pen[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int pos = cc * kSliceRows + Tile::col_of(ni, c);
              // explicit roundings: no fused multiply-add, so the int8 pools
              // are bit-identical to the plain version's
              pen[c] = pos >= l && pos < h ? (ip ? 0.f : __fmul_rn(norms[a + pos], half_inv))
                                           : INFINITY;
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                chain_insert(best[mi][ni][e], bidx[mi][ni][e], cap,
                             __fsub_rn(static_cast<float>(acc[mi][ni][e]), pen[e & 1]), cc);
          }
        });
  }
  // elements e = 2 hf, 2 hf + 1 are lanes c, c + 1 of one slot: one 8-byte
  // and one 2-byte store each, so a quad fills whole 32-byte sectors
  const float f = ip ? -scale : -2.0f * scale;
  const size_t F = static_cast<size_t>(cap) * kSliceRows;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + Tile::row_of(mi, 2 * hf);
      if (m >= M) continue;
      const size_t o = (static_cast<size_t>(t) * M + m) * F;
      for (int r = 0; r < cap; ++r)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const size_t at = o + r * kSliceRows + Tile::col_of(ni, 0);
          *reinterpret_cast<float2*>(out_v + at) =
              make_float2(f * best[mi][ni][2 * hf][r], f * best[mi][ni][2 * hf + 1][r]);
          *reinterpret_cast<uchar2*>(out_i + at) =
              make_uchar2(static_cast<uint8_t>(bidx[mi][ni][2 * hf][r]),
                          static_cast<uint8_t>(bidx[mi][ni][2 * hf + 1][r]));
        }
    }
}

// f32 rows, or bf16 rows with f32 queries (and f32 rows with bf16 queries):
// the FMA loop of tile_dot.cuh. grid = (n_tiles, ceil(M / kBQ)).
template <typename T, typename TQ, int kCap>
__global__ void __launch_bounds__(kThreads)
ivf_scan_fma_kernel(const T* __restrict__ data, const float* __restrict__ norms,
                    const TQ* __restrict__ q, const int* __restrict__ qidx,
                    const int* __restrict__ al, const int* __restrict__ lo,
                    const int* __restrict__ sizes, const float* __restrict__ scale_p, int M,
                    int dp, int n_rows, int W, int cap_rt, int ip, float* __restrict__ out_v,
                    uint8_t* __restrict__ out_i) {
  constexpr int kDepth = kCap > 0 ? kCap : kMaxCap;
  const int cap = kCap > 0 ? kCap : cap_rt;
  __shared__ __align__(16) float qs[kBQ * kPad];
  __shared__ __align__(16) float xs[kLanes * kPad];

  const int t = blockIdx.x;
  const int m0 = blockIdx.y * kBQ;
  const int tq = threadIdx.x / kLaneThreads, tl = threadIdx.x % kLaneThreads;
  const float scale = *scale_p;
  const float half_inv = 0.5f / scale;
  const int a = al[t];
  const int l = lo[t];
  const int h = l + sizes[t];

  float best[kTQ][kTL][kDepth];
  int bidx[kTQ][kTL][kDepth];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j)
      for (int r = 0; r < cap; ++r) {
        best[i][j][r] = -INFINITY;
        bidx[i][j][r] = 0;
      }

  auto q_row = [&](int r) -> const TQ* {
    const int m = m0 + r;
    const int qi = m < M ? qidx[static_cast<size_t>(t) * M + m] : -1;
    return qi >= 0 ? q + static_cast<size_t>(qi) * dp : nullptr;
  };
  const int cc_lo = h > l ? l / kLanes : 0;
  const int cc_hi = h > l ? min((h + kLanes - 1) / kLanes, W / kLanes) : 0;
  for (int cc = cc_lo; cc < cc_hi; ++cc) {
    const int p0 = cc * kLanes;
    auto x_row = [&](int r) -> const T* {
      const int row = a + p0 + r;
      return (row >= 0 && row < n_rows) ? data + static_cast<size_t>(row) * dp : nullptr;
    };
    float acc[kTQ][kTL];
    slice_dots<TQ, T>(qs, xs, q_row, x_row, dp, tq, tl, acc);
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      const int pos = p0 + tl + kLaneThreads * j;
      const bool valid = pos >= l && pos < h;
      const float pen = valid ? (ip ? 0.f : __fmul_rn(norms[a + pos], half_inv)) : INFINITY;
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
        chain_insert(best[i][j], bidx[i][j], cap, __fsub_rn(acc[i][j], pen), cc);
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
        out_v[o + r * kLanes + lane] = f * best[i][j][r];
        out_i[o + r * kLanes + lane] = static_cast<uint8_t>(bidx[i][j][r]);
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

// The widest slot block (kWM = 2, then 1) whose shared memory fits.
template <typename T, int kWM = 2>
cudaError_t launch_mma(const ScanArgs& s, cudaStream_t st) {
  using Tile = MmaTile<T, kWM>;
  const size_t smem = Tile::smem_bytes(s.dp);
  if (smem > kMaxSmem) {
    if constexpr (kWM > 1)
      return launch_mma<T, kWM / 2>(s, st);
    else
      return cudaErrorInvalidValue;
  }
  auto kernel = s.cap == 2 ? ivf_scan_mma_kernel<T, kWM, 2> : ivf_scan_mma_kernel<T, kWM, 0>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int vec = (static_cast<size_t>(s.dp) * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.data) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.q) % 16 == 0;
  const dim3 grid(s.n_tiles * ((s.M + Tile::kBQ - 1) / Tile::kBQ));
  kernel<<<grid, Tile::kThreads, smem, st>>>(
      static_cast<const T*>(s.data), s.norms, static_cast<const T*>(s.q), s.qidx, s.al, s.lo,
      s.sizes, s.scale, s.M, s.dp, s.n_rows, s.W, s.cap, s.ip, vec, s.out_v, s.out_i);
  return cudaGetLastError();
}

template <typename T, typename TQ>
cudaError_t launch_fma(const ScanArgs& s, cudaStream_t st) {
  auto kernel = s.cap == 2 ? ivf_scan_fma_kernel<T, TQ, 2> : ivf_scan_fma_kernel<T, TQ, 0>;
  const dim3 grid(s.n_tiles, (s.M + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, 0, st>>>(static_cast<const T*>(s.data), s.norms,
                                    static_cast<const TQ*>(s.q), s.qidx, s.al, s.lo, s.sizes,
                                    s.scale, s.M, s.dp, s.n_rows, s.W, s.cap, s.ip, s.out_v,
                                    s.out_i);
  return cudaGetLastError();
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
  const ScanArgs s{data, norms, q, qidx, al, lo, sizes, scale, n_tiles, M, dp, n_rows, W, cap,
                   ip, out_v, out_i};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == kI8 && qdtype == kI8)
    e = launch_mma<int8_t>(s, st);
  else if (dtype == kBF16 && qdtype == kBF16)
    e = launch_mma<__nv_bfloat16>(s, st);
  else if (dtype == kF32 && qdtype == kF32)
    e = launch_fma<float, float>(s, st);
  else if (dtype == kF32 && qdtype == kBF16)
    e = launch_fma<float, __nv_bfloat16>(s, st);
  else if (dtype == kBF16 && qdtype == kF32)
    e = launch_fma<__nv_bfloat16, float>(s, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
