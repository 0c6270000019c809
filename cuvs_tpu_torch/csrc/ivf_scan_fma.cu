// The fp32 IVF-Flat scan for Hopper (sm_90a): ivf_scan_fma_kernel replaces
// cuvs_tpu/ops/ivf_scan_pallas.py::_scan_kernel for f32 rows and for bf16
// rows searched with f32 queries (via fused_ivf_scan; the contract is
// ivf_scan.cu's).
//
// The design (f32 rows are IVF-Flat's default storage):
//  * IEEE fp32 on the CUDA cores, as the plain version and the brute
//    force's ground truth: no TF32, no split precision. At the bench CLI's
//    f32 IVF-Flat call (1M x 128, 1024 lists, 10,000 queries x 10 probes,
//    about 1e5 pairs of ~980 rows) the products are about 2.5e10 operations,
//    0.374 ms at 67 TFLOP/s, more than its bytes take (rows read once, pool
//    written once): operations bound it.
//  * The brute force's fp32 tile (fma_tile.cuh, FmaTile<4>): 256 threads, a
//    thread owns 4 slots x 8 lanes (16 FMA per float4 shared load) for the
//    whole window. The slots' query rows are gathered once through qidx (an
//    empty slot is a row of zeros) and stay in shared memory while the
//    window's 128-row slices stream through a three-slot cp.async ring, 32
//    values of k a chunk, one barrier a chunk, so the copies of the next
//    chunks overlap this one's products. Where the query rows do not fit
//    (dp above 672 with f32 rows, 768 with bf16) or cap is not 2, they
//    stream through the ring beside each slice instead (2-3.5% slower at
//    dp = 128 on the H100). bf16 rows are staged as bf16 and widened as the
//    tile reads them (exact), so a bf16 index is never cast per search; the
//    wrapper widens bf16 queries.
//  * A block none of whose 64 slots holds a query (a tile of a list probed
//    by at most 64 pairs leaves its second block empty: most lists at 4096
//    queries x 10 probes over 1024 lists) reads no row of the window: its
//    products are all 0, the plain version's zero query rows, so only the
//    penalties run through the chain and its pool is unchanged.
//  * The epilogue is the MMA kernel's (ivf_scan.cu): per slice each
//    accumulator is one (slot, lane bin) of one thread, penalty subtracted
//    with explicit roundings and chained in slice order (integer-valued rows
//    give pools bit-identical to the plain version's). State for cap 2 (64
//    values, 64 slice ids) sits in registers beside the 32 accumulators.
#include "fma_tile.cuh"
#include "ivf_scan.cuh"

#include <math.h>

namespace cuvs_tpu_torch {

// f32 rows, or bf16 rows with f32 queries, on the fp32 tile (fma_tile.cuh).
// kCap as in ivf_scan_mma_kernel (ivf_scan.cu). kResident: the block's query rows stay in
// shared memory and the ring streams dataset rows alone; otherwise both
// stream through it. n_tiles * ceil(M / kBQ) blocks.
constexpr int kFmaStages = 3;

template <typename TX, int kCap, bool kResident>
__global__ void __launch_bounds__(FmaTile<4, TX>::kThreads, 1)
ivf_scan_fma_kernel(const TX* __restrict__ data, const float* __restrict__ norms,
                    const float* __restrict__ q, const int* __restrict__ qidx,
                    const int* __restrict__ al, const int* __restrict__ lo,
                    const int* __restrict__ sizes, const float* __restrict__ scale_p, int M,
                    int dp, int n_rows, int W, int cap_rt, int ip, int vec,
                    float* __restrict__ out_v, uint8_t* __restrict__ out_i) {
  using Tile = FmaTile<4, TX>;
  constexpr int kTM = 4, kTN = Tile::kTN, kBQ = Tile::kBQ;
  constexpr int kDepth = kCap > 0 ? kCap : kMaxCap;
  const int cap = kCap > 0 ? kCap : cap_rt;
  extern __shared__ __align__(128) char smem[];

  const int n_qb = (M + kBQ - 1) / kBQ;  // a tile's blocks are adjacent
  const int t = blockIdx.x / n_qb, m0 = blockIdx.x % n_qb * kBQ;
  const float scale = *scale_p;
  const float half_inv = 0.5f / scale;
  const int a = al[t], l = lo[t], h = l + sizes[t];
  const int* slot_q = qidx + static_cast<size_t>(t) * M + m0;
  // any query in the block's slots? (filled slots need not be a prefix)
  const int filled = __syncthreads_or(threadIdx.x < kBQ && m0 + static_cast<int>(threadIdx.x) < M &&
                                      slot_q[threadIdx.x] >= 0);

  float best[kTM][kTN][kDepth];
  int bidx[kTM][kTN][kDepth];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      for (int r = 0; r < cap; ++r) {
        best[i][j][r] = -INFINITY;
        bidx[i][j][r] = 0;
      }
  float acc[kTM][kTN];
  auto zero_acc = [&] {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  };
  // slice cc's scores into the bins, in slice order
  auto insert_slice = [&](int cc) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int pos = cc * kSliceRows + Tile::col_of(j);
      // explicit roundings: no fused multiply-add, as in the plain version
      const float pen = pos >= l && pos < h ? (ip ? 0.f : __fmul_rn(norms[a + pos], half_inv))
                                            : INFINITY;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        chain_insert(best[i][j], bidx[i][j], cap, __fsub_rn(acc[i][j], pen), cc);
    }
  };
  // slices [cc_lo, cc_hi) cover the list's window positions [l, h)
  const int cc_lo = h > l ? l / kSliceRows : 0;
  const int cc_hi = h > l ? min((h + kSliceRows - 1) / kSliceRows, W / kSliceRows) : 0;
  if (filled && cc_hi > cc_lo) {  // uniform in the block
    const int nk = Tile::n_chunks_k(dp);
    auto q_row = [&](int r) -> const float* {
      const int qi = m0 + r < M ? slot_q[r] : -1;
      return qi >= 0 ? q + static_cast<size_t>(qi) * dp : nullptr;
    };
    // resident query rows (their copies land with the first chunk's), then the ring
    const int q_stride = nk * Tile::kBK + 4;
    float* qs = reinterpret_cast<float*>(smem);
    char* ring = kResident ? smem + static_cast<size_t>(kBQ) * q_stride * 4 : smem;
    constexpr int kSlotBytes = kResident ? Tile::kXStageBytes : Tile::kStageBytes;
    if constexpr (kResident) Tile::stage_queries(qs, q_stride, q_row, nk, dp, vec);
    run_chunks<kFmaStages, 1>(
        (cc_hi - cc_lo) * nk,
        [&](int j, int slot) {
          // the staging rows are found anew each chunk: held across the
          // products, their pointers would spill the cap-2 state
          const int r0 = a + (cc_lo + j / nk) * kSliceRows;
          auto x_row = [&](int r) -> const TX* {
            return r0 + r < n_rows ? data + static_cast<size_t>(r0 + r) * dp : nullptr;
          };
          char* dst = ring + slot * kSlotBytes;
          if constexpr (kResident) {
            const TX* rows[Tile::kXRows];
            Tile::x_rows(rows, x_row);
            Tile::stage_x(reinterpret_cast<TX*>(dst), rows, j % nk, dp, vec);
          } else {
            typename Tile::Rows rows;
            Tile::rows(rows, q_row, x_row);
            Tile::stage(reinterpret_cast<float*>(dst), rows, j % nk, dp, vec);
          }
        },
        [&](int i, int slot) {
          const int kc = i % nk;
          if (kc == 0) zero_acc();
          const char* src = ring + slot * kSlotBytes;
          if constexpr (kResident)
            Tile::compute(qs + kc * Tile::kBK, q_stride, reinterpret_cast<const TX*>(src), acc);
          else
            Tile::compute(reinterpret_cast<const float*>(src), acc);
          if (kc == nk - 1) insert_slice(cc_lo + i / nk);
        });
  } else if (cc_hi > cc_lo) {
    // no slot holds a query: every product is 0 (the plain version's zero
    // query rows), so the window's rows need not be read
    zero_acc();
    for (int cc = cc_lo; cc < cc_hi; ++cc) insert_slice(cc);
  }
  const float f = ip ? -scale : -2.0f * scale;
  const size_t F = static_cast<size_t>(cap) * kSliceRows;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + Tile::row_of(i);
    if (m >= M) continue;
    const size_t o = (static_cast<size_t>(t) * M + m) * F;
    for (int r = 0; r < cap; ++r)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const size_t at = o + r * kSliceRows + Tile::col_of(j);
        out_v[at] = f * best[i][j][r];
        out_i[at] = static_cast<uint8_t>(bidx[i][j][r]);
      }
  }
}

// Query rows resident where they fit, at cap 2: the runtime-depth path
// (k > 64) keeps the ring, one mainloop fewer to build.
template <typename TX>
cudaError_t launch_fma(const ScanArgs& s, cudaStream_t st) {
  using Tile = FmaTile<4, TX>;
  const size_t q_bytes =
      static_cast<size_t>(Tile::kBQ) * (Tile::n_chunks_k(s.dp) * Tile::kBK + 4) * 4;
  const size_t resident = q_bytes + static_cast<size_t>(kFmaStages) * Tile::kXStageBytes;
  const bool res = s.cap == 2 && resident <= kMaxSmem;
  const size_t smem = res ? resident : static_cast<size_t>(kFmaStages) * Tile::kStageBytes;
  auto kernel = res ? ivf_scan_fma_kernel<TX, 2, true>
                    : s.cap == 2 ? ivf_scan_fma_kernel<TX, 2, false>
                                 : ivf_scan_fma_kernel<TX, 0, false>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // queries are f32: a whole TX unit of dp implies a whole f32 one
  const int vec = (static_cast<size_t>(s.dp) * sizeof(TX)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.data) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.q) % 16 == 0;
  const dim3 grid(s.n_tiles * ((s.M + Tile::kBQ - 1) / Tile::kBQ));
  kernel<<<grid, Tile::kThreads, smem, st>>>(
      static_cast<const TX*>(s.data), s.norms, static_cast<const float*>(s.q), s.qidx, s.al,
      s.lo, s.sizes, s.scale, s.M, s.dp, s.n_rows, s.W, s.cap, s.ip, vec, s.out_v, s.out_i);
  return cudaGetLastError();
}

template cudaError_t launch_fma<float>(const ScanArgs&, cudaStream_t);
template cudaError_t launch_fma<__nv_bfloat16>(const ScanArgs&, cudaStream_t);

}  // namespace cuvs_tpu_torch
