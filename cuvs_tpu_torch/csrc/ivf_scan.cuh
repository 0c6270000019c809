// The IVF-Flat scan's two kernels and what its four sources share:
// ivf_scan.cu (the C entry point, bf16 and int8 rows on tensor cores at
// cap <= 2), ivf_scan_fma.cu (f32 rows, and bf16 rows with f32 queries, on
// the fp32 tile at cap <= 2), ivf_scan_deep.cu and ivf_scan_deep32.cu (both
// tiles at cap 3-32: every search with k > 64). They are four sources so
// that nvcc builds them in parallel processes.
//
// Bins. Each accumulator element of a tile is one (slot, lane bin), owned by
// one thread for the whole window, which subtracts its penalty and runs the
// bin's chain (bins.cuh) in slice order after each slice's products. At
// cap <= 2 (kD = 2) a thread keeps every element of the cap-2 tiles, 32, with
// two levels each (Bins2) beside 32 accumulators: 128 registers of state.
// Deeper bins cannot: a level is 1.25 registers (the score, a byte of a
// packed slice id), so 32 elements at depth 4 alone take 160. The deep
// kernels run a compile-time depth class kD in {4, 8, 16, 32} >= the levels
// a call can fill, min(cap, W / 128) (a bin takes one score a slice; levels
// past that hold -inf and write as constants), with fully unrolled chains,
// and keep fewer elements a thread: a block multiplies and keeps only one of
// kParts column parts of each slice, and the tensor-core tile runs 16-slot
// warp rows (kMI = 1), so every class holds 64 levels (80 registers) of bins
// a thread (launch_deep_class). The parts of a slot block are adjacent
// blocks that read the same window through L2.
#pragma once

#include "bins.cuh"
#include "dtype.cuh"
#include "fma_tile.cuh"
#include "mma_tile.cuh"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cuvs_tpu_torch {

constexpr int kMaxCap = 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may take
constexpr int kFmaStages = 3;        // ring slots of the fp32 tile's chunks

template <int kD>
using LaneBins = typename std::conditional<kD == 2, Bins2, Bins<kD>>::type;

struct ScanArgs {
  const void* data;
  const float* norms;
  const void* q;
  const int *qidx, *al, *lo, *sizes;
  const float* scale;
  int n_tiles, M, dp, n_rows, W, cap, ip;
  float* out_v;
  uint8_t* out_i;
  // set: report the kernel a launch would run instead of launching it
  // (registers, local bytes, depth class, slots a block, parts, threads)
  int* attributes;
};

// The depth class of a call with cap > 2: a bin takes one score a slice, so
// its levels past min(cap, W / 128) stay empty.
inline int depth_class(int cap, int W) {
  const int d = cap < W / kSliceRows ? cap : W / kSliceRows;
  return d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : 32;
}

// Write the first cap levels of one output column: level(r) for the bins'
// levels r < kD, empty(r) (f * -inf, slice 0) past them.
template <int kD, typename Level, typename Empty>
__device__ __forceinline__ void store_levels(int cap, Level level, Empty empty) {
#pragma unroll
  for (int r = 0; r < kD; ++r)
    if (r < cap) level(r);
  for (int r = kD; r < cap; ++r) empty(r);
}

// bf16 or int8 rows and queries on tensor cores (mma_tile.cuh), bins kD
// deep. The block: kWM rows of warps of 16 * kMI slots, kBQ slots; it keeps
// column part `part` of kParts of each warp's 32 columns: MMA tiles
// [ni0, ni0 + kN), and with kParts = 8 one column (c0) of each thread's pair.
// n_tiles * ceil(M / kBQ) * kParts blocks, a tile's adjacent. At kD > 2 a
// block none of whose slots holds a query reads no row of the window: its
// products are 0, the plain version's zero query rows, so only the
// penalties go through the chain. The deep classes take one chunk a barrier
// (the ring's slots unchanged): the chain's code is then built once for the
// mainloop, not once for each chunk of a group, which keeps ivf_scan_deep.cu
// under the build's longest nvcc (NVIDIA H100: bf16 rows at k = 100 took
// 1.96-1.99 ms, against 1.89 with two chunks a barrier in another run).
template <typename T, int kWM, int kMI, int kD, int kParts>
__global__ void __launch_bounds__(MmaTile<T, kWM, kMI>::kThreads, 1)
ivf_scan_mma_kernel(const T* __restrict__ data, const float* __restrict__ norms,
                    const T* __restrict__ q, const int* __restrict__ qidx,
                    const int* __restrict__ al, const int* __restrict__ lo,
                    const int* __restrict__ sizes, const float* __restrict__ scale_p, int M,
                    int dp, int n_rows, int W, int cap, int ip, int vec,
                    float* __restrict__ out_v, uint8_t* __restrict__ out_i) {
  using Tile = MmaTile<T, kWM, kMI>;
  using Acc = typename Tile::Acc;
  static_assert(kParts == 1 || kParts == 2 || kParts == 4 || kParts == 8, "column parts");
  constexpr int kBQ = Tile::kBQ;
  constexpr int kN = kParts >= 4 ? 1 : 4 / kParts;  // MMA tiles kept per warp
  constexpr int kC = kParts == 8 ? 1 : 2;           // columns kept of each pair
  extern __shared__ __align__(128) char smem[];
  const int nk = Tile::n_chunks_k(dp);
  char* qs = smem;
  char* ring = qs + static_cast<size_t>(kBQ) * nk * kChunkBytes;

  const int n_qb = (M + kBQ - 1) / kBQ;
  const int t = blockIdx.x / (n_qb * kParts), m0 = blockIdx.x / kParts % n_qb * kBQ;
  const int part = blockIdx.x % kParts;
  const int ni0 = kParts == 8 ? part / 2 : part * kN, c0 = kParts == 8 ? part % 2 : 0;
  const float scale = *scale_p;
  const float half_inv = 0.5f / scale;
  const int a = al[t], l = lo[t], h = l + sizes[t];

  LaneBins<kD> bins[kMI][kN][2 * kC];  // [mi][n][2 * row half + column]
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 2 * kC; ++e) bins[mi][n][e].clear();
  Acc acc[kMI][kN][4];
  // slice cc's scores into the bins, in slice order
  auto insert_slice = [&](int cc) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float pen[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int pos = cc * kSliceRows + Tile::col_of(ni0 + n, c0 + c);
        // explicit roundings: no fused multiply-add, so the int8 pools
        // are bit-identical to the plain version's
        pen[c] = pos >= l && pos < h ? (ip ? 0.f : __fmul_rn(norms[a + pos], half_inv))
                                     : INFINITY;
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const Acc s = kC == 2 ? acc[mi][n][2 * hf + c]
                                  : (c0 ? acc[mi][n][2 * hf + 1] : acc[mi][n][2 * hf]);
            bins[mi][n][kC * hf + c].insert(__fsub_rn(static_cast<float>(s), pen[c]), cc);
          }
    }
  };
  auto zero_acc = [&] {
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = Acc(0);
  };
  bool filled = true;
  if constexpr (kD > 2) {
    const int* slot_q = qidx + static_cast<size_t>(t) * M + m0;
    filled = __syncthreads_or(threadIdx.x < kBQ && m0 + static_cast<int>(threadIdx.x) < M &&
                              slot_q[threadIdx.x] >= 0);
  }
  // slices [cc_lo, cc_hi) cover the list's window positions [l, h)
  const int cc_lo = h > l ? l / kSliceRows : 0;
  const int cc_hi = h > l ? min((h + kSliceRows - 1) / kSliceRows, W / kSliceRows) : 0;
  if (filled && cc_hi > cc_lo) {  // uniform in the block
    Tile::stage_query_rows(qs, [&](int r) -> const T* {
      const int m = m0 + r;
      const int qi = m < M ? qidx[static_cast<size_t>(t) * M + m] : -1;
      return qi >= 0 ? q + static_cast<size_t>(qi) * dp : nullptr;
    }, dp, vec);
    const T* rows[Tile::kRowsPerThread];
    constexpr int kGroup = kD > 2 ? 1 : Tile::kGroup;
    run_chunks<Tile::kStages * Tile::kGroup / kGroup, kGroup>(
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
          const int kc = i % nk;
          if (kc == 0) zero_acc();
          Tile::compute(qs + static_cast<size_t>(kc) * kBQ * kChunkBytes,
                        ring + slot * Tile::kTileBytes, acc, ni0);
          if (kc == nk - 1) insert_slice(cc_lo + i / nk);
        });
  } else if (kD > 2 && cc_hi > cc_lo) {
    zero_acc();
    for (int cc = cc_lo; cc < cc_hi; ++cc) insert_slice(cc);
  }
  // with both columns of a pair, elements 2 hf, 2 hf + 1 are lanes c, c + 1
  // of one slot: one 8-byte and one 2-byte store each, so a quad fills
  // whole 32-byte sectors
  const float f = ip ? -scale : -2.0f * scale;
  const size_t F = static_cast<size_t>(cap) * kSliceRows;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + Tile::row_of(mi, 2 * hf);
      if (m >= M) continue;
      const size_t o = (static_cast<size_t>(t) * M + m) * F;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const LaneBins<kD>* b = bins[mi][n] + kC * hf;
        const size_t at = o + Tile::col_of(ni0 + n, c0);
        if constexpr (kC == 2)
          store_levels<kD>(cap, [&](int r) {
            *reinterpret_cast<float2*>(out_v + at + r * kSliceRows) =
                make_float2(f * b[0].v[r], f * b[1].v[r]);
            *reinterpret_cast<uchar2*>(out_i + at + r * kSliceRows) =
                make_uchar2(static_cast<uint8_t>(b[0].slice(r)),
                            static_cast<uint8_t>(b[1].slice(r)));
          }, [&](int r) {
            *reinterpret_cast<float2*>(out_v + at + r * kSliceRows) =
                make_float2(f * -INFINITY, f * -INFINITY);
            *reinterpret_cast<uchar2*>(out_i + at + r * kSliceRows) = make_uchar2(0, 0);
          });
        else
          store_levels<kD>(cap, [&](int r) {
            out_v[at + r * kSliceRows] = f * b[0].v[r];
            out_i[at + r * kSliceRows] = static_cast<uint8_t>(b[0].slice(r));
          }, [&](int r) {
            out_v[at + r * kSliceRows] = f * -INFINITY;
            out_i[at + r * kSliceRows] = 0;
          });
      }
    }
}

// f32 rows, or bf16 rows with f32 queries, on the fp32 tile (fma_tile.cuh),
// bins kD deep. The block: 16 * kTM slots; it keeps column part `part` of
// kParts: the thread's columns col_of(j0 + j), j < kTN / kParts.
// kResident: the block's query rows stay in shared memory and the ring
// streams dataset rows alone; otherwise both stream through it. A block
// none of whose slots holds a query reads no row of the window: its
// products are 0, the plain version's zero query rows, so only the
// penalties go through the chain: at kD > 2 in the mainloop's own steps, a
// slice a step, which builds one copy of the chain's code fewer (nvcc) and
// cost no time on this tile (NVIDIA H100 machine: f32 rows at k = 100
// 8.15-8.20 ms against 8.29; on the tensor-core tile it cost 5%).
// n_tiles * ceil(M / kBQ) * kParts blocks, a tile's adjacent.
template <typename TX, int kTM, int kD, int kParts, bool kResident>
__global__ void __launch_bounds__(FmaTile<kTM, TX>::kThreads, 1)
ivf_scan_fma_kernel(const TX* __restrict__ data, const float* __restrict__ norms,
                    const float* __restrict__ q, const int* __restrict__ qidx,
                    const int* __restrict__ al, const int* __restrict__ lo,
                    const int* __restrict__ sizes, const float* __restrict__ scale_p, int M,
                    int dp, int n_rows, int W, int cap, int ip, int vec,
                    float* __restrict__ out_v, uint8_t* __restrict__ out_i) {
  using Tile = FmaTile<kTM, TX>;
  constexpr int kN = Tile::kTN / kParts, kBQ = Tile::kBQ;
  static_assert(kN * kParts == Tile::kTN, "column parts");
  extern __shared__ __align__(128) char smem[];

  const int n_qb = (M + kBQ - 1) / kBQ;
  const int t = blockIdx.x / (n_qb * kParts), m0 = blockIdx.x / kParts % n_qb * kBQ;
  const int j0 = blockIdx.x % kParts * kN;
  const float scale = *scale_p;
  const float half_inv = 0.5f / scale;
  const int a = al[t], l = lo[t], h = l + sizes[t];
  const int* slot_q = qidx + static_cast<size_t>(t) * M + m0;
  // any query in the block's slots? (filled slots need not be a prefix)
  const int filled = __syncthreads_or(threadIdx.x < kBQ && m0 + static_cast<int>(threadIdx.x) < M &&
                                      slot_q[threadIdx.x] >= 0);

  LaneBins<kD> bins[kTM][kN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) bins[i][j].clear();
  float acc[kTM][kN];
  auto zero_acc = [&] {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[i][j] = 0.f;
  };
  // slice cc's scores into the bins, in slice order
  auto insert_slice = [&](int cc) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int pos = cc * kSliceRows + Tile::col_of(j0 + j);
      // explicit roundings: no fused multiply-add, as in the plain version
      const float pen = pos >= l && pos < h ? (ip ? 0.f : __fmul_rn(norms[a + pos], half_inv))
                                            : INFINITY;
#pragma unroll
      for (int i = 0; i < kTM; ++i) bins[i][j].insert(__fsub_rn(acc[i][j], pen), cc);
    }
  };
  // slices [cc_lo, cc_hi) cover the list's window positions [l, h)
  const int cc_lo = h > l ? l / kSliceRows : 0;
  const int cc_hi = h > l ? min((h + kSliceRows - 1) / kSliceRows, W / kSliceRows) : 0;
  constexpr bool kFold = kD > 2;
  if ((kFold || filled) && cc_hi > cc_lo) {  // uniform in the block
    const int nk = Tile::n_chunks_k(dp);
    const int nks = !kFold || filled ? nk : 1;  // steps a slice
    auto q_row = [&](int r) -> const float* {
      const int qi = m0 + r < M ? slot_q[r] : -1;
      return qi >= 0 ? q + static_cast<size_t>(qi) * dp : nullptr;
    };
    // resident query rows (their copies land with the first chunk's), then the ring
    const int q_stride = nk * Tile::kBK + 4;
    float* qs = reinterpret_cast<float*>(smem);
    char* ring = kResident ? smem + static_cast<size_t>(kBQ) * q_stride * 4 : smem;
    constexpr int kSlotBytes = kResident ? Tile::kXStageBytes : Tile::kStageBytes;
    if constexpr (kResident)
      if (!kFold || filled) Tile::stage_queries(qs, q_stride, q_row, nk, dp, vec);
    run_chunks<kFmaStages, 1>(
        (cc_hi - cc_lo) * nks,
        [&](int j, int slot) {
          if (kFold && !filled) return;
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
          const int kc = i % nks;
          if (kc == 0) zero_acc();
          const char* src = ring + slot * kSlotBytes;
          // the part's first column group: dataset rows 16 * j0 on
          const int x0 = 16 * j0 * Tile::kXStride;
          if (!kFold || filled) {
            if constexpr (kResident)
              Tile::compute(qs + kc * Tile::kBK, q_stride,
                            reinterpret_cast<const TX*>(src) + x0, acc);
            else
              Tile::compute(reinterpret_cast<const float*>(src), Tile::kStride,
                            reinterpret_cast<const TX*>(reinterpret_cast<const float*>(src) +
                                                        kBQ * Tile::kStride) + x0,
                            acc);
          }
          if (kc == nks - 1) insert_slice(cc_lo + i / nks);
        });
  } else if (!kFold && cc_hi > cc_lo) {
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
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const size_t at = o + Tile::col_of(j0 + j);
      store_levels<kD>(cap, [&](int r) {
        out_v[at + r * kSliceRows] = f * bins[i][j].v[r];
        out_i[at + r * kSliceRows] = static_cast<uint8_t>(bins[i][j].slice(r));
      }, [&](int r) {
        out_v[at + r * kSliceRows] = f * -INFINITY;
        out_i[at + r * kSliceRows] = 0;
      });
    }
  }
}

// Launch one instantiation over n_tiles * ceil(M / slots) * parts blocks, or
// with s.attributes set, report it.
template <typename TD, typename TQ>
cudaError_t launch_scan(void (*kernel)(const TD*, const float*, const TQ*, const int*, const int*,
                                       const int*, const int*, const float*, int, int, int, int,
                                       int, int, int, float*, uint8_t*),
                        const ScanArgs& s, size_t smem, int threads, int slots, int parts,
                        int depth, int vec, cudaStream_t st) {
  if (s.attributes != nullptr) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    const int report[6] = {fa.numRegs, static_cast<int>(fa.localSizeBytes), depth, slots, parts,
                           threads};
    for (int i = 0; i < 6; ++i) s.attributes[i] = report[i];
    return e;
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(s.n_tiles * ((s.M + slots - 1) / slots) * parts);
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const TD*>(s.data), s.norms, static_cast<const TQ*>(s.q), s.qidx, s.al, s.lo,
      s.sizes, s.scale, s.M, s.dp, s.n_rows, s.W, s.cap, s.ip, vec, s.out_v, s.out_i);
  return cudaGetLastError();
}

// The tensor-core tile at its widest slot block (kWM = 2, then 1) whose
// shared memory fits.
template <typename T, int kMI, int kD, int kParts, int kWM = 2>
cudaError_t launch_mma(const ScanArgs& s, cudaStream_t st) {
  using Tile = MmaTile<T, kWM, kMI>;
  const size_t smem = Tile::smem_bytes(s.dp);
  if (smem > kMaxSmem) {
    if constexpr (kWM > 1)
      return launch_mma<T, kMI, kD, kParts, kWM / 2>(s, st);
    else
      return cudaErrorInvalidValue;
  }
  const int vec = (static_cast<size_t>(s.dp) * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.data) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.q) % 16 == 0;
  return launch_scan(ivf_scan_mma_kernel<T, kWM, kMI, kD, kParts>, s, smem, Tile::kThreads,
                     Tile::kBQ, kParts, kD, vec, st);
}

// The fp32 tile with its query rows resident where they fit, else streamed
// through the ring beside each slice (dp above 672 with f32 rows and the
// cap-2 block).
template <typename TX, int kTM, int kD, int kParts>
cudaError_t launch_fma(const ScanArgs& s, cudaStream_t st) {
  using Tile = FmaTile<kTM, TX>;
  const size_t q_bytes =
      static_cast<size_t>(Tile::kBQ) * (Tile::n_chunks_k(s.dp) * Tile::kBK + 4) * 4;
  const size_t resident = q_bytes + static_cast<size_t>(kFmaStages) * Tile::kXStageBytes;
  const bool res = resident <= kMaxSmem;
  const size_t smem = res ? resident : static_cast<size_t>(kFmaStages) * Tile::kStageBytes;
  // queries are f32: a whole TX unit of dp implies a whole f32 one
  const int vec = (static_cast<size_t>(s.dp) * sizeof(TX)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.data) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.q) % 16 == 0;
  return launch_scan(res ? ivf_scan_fma_kernel<TX, kTM, kD, kParts, true>
                         : ivf_scan_fma_kernel<TX, kTM, kD, kParts, false>,
                     s, smem, Tile::kThreads, Tile::kBQ, kParts, kD, vec, st);
}

// One deep class's block plan (ivf_scan_deep.cu): tensor cores (bf16 or
// int8 queries) in 32-slot blocks keeping one of kD / 4 column parts; the
// fp32 tile (f32 queries) in 64-slot blocks keeping one of kD / 2, and at
// kD = 32 in 32-slot blocks keeping one of 8.
template <int kD>
cudaError_t launch_deep_class(int dtype, int qdtype, const ScanArgs& s, cudaStream_t st) {
  constexpr int kTM = kD < 32 ? 4 : 2, kFmaParts = kD < 32 ? kD / 2 : 8;
  if (qdtype != kF32)
    return dtype == kI8 ? launch_mma<int8_t, 1, kD, kD / 4>(s, st)
                        : launch_mma<__nv_bfloat16, 1, kD, kD / 4>(s, st);
  return dtype == kF32 ? launch_fma<float, kTM, kD, kFmaParts>(s, st)
                       : launch_fma<__nv_bfloat16, kTM, kD, kFmaParts>(s, st);
}

// Each source's launcher: the fp32 tile at cap <= 2 (ivf_scan_fma.cu; rows
// of type xdtype, f32 queries); cap 3-32, either tile (ivf_scan_deep.cu, and
// depth classes 16 and 32 in ivf_scan_deep32.cu).
cudaError_t launch_fma_cap2(int xdtype, const ScanArgs& s, cudaStream_t st);
cudaError_t launch_deep(int dtype, int qdtype, const ScanArgs& s, cudaStream_t st);
cudaError_t launch_deep32(int dtype, int qdtype, int depth, const ScanArgs& s,
                          cudaStream_t st);

}  // namespace cuvs_tpu_torch
