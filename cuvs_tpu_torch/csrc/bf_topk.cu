// Fused brute-force distance + top-k kernels for Hopper (sm_90a).
//
// bf_topk_exact: replaces cuvs_tpu/ops/bf_topk_pallas.py::_fused_kernel
// (exact=True). Per (dataset tile, query) the exact top-k of
// max(|q|^2 + |x|^2 - 2 q.x, 0) (L2) or -q.x (IP), ties to the lowest column,
// emitted as a [n_tiles, B, k] pool that the caller merges. float32 rows back
// ground truth and stay IEEE fp32 (fma_tile.cuh: bound by 2*B*N*d operations
// at 67 TFLOP/s on this card); bf16 and int8 rows take the tensor-core tile
// (mma_tile.cuh).
//
// bf_topk_approx: replaces _approx_kernel (exact=False), float and int8
// paths. Per (tile, query, lane bin) the best score q.x - pen over the tile's
// C = tile_n/128 strided slices, emitted as a [n_tiles, B, 128] pool of
// min-space values plus the uint8 winning slice. bf16 and int8 rows run on
// tensor cores (bound by the products at 989 TFLOP/s bf16 / 1979 TOP/s int8,
// and by the dataset's trips through L2); float32 rows stay exact fp32 on the
// fp32 tile.
//
// What the design does about it:
//  * Grid: one block per (tile, query block), the query block fastest, so the
//    blocks of one tile run together and read it from device memory about
//    once per batch (the TPU kernel's dataset-stationary order).
//  * Approx epilogue in registers: after each slice's products, every
//    accumulator element updates its (query, lane bin) running best in the
//    same thread -- float and int8 chain: score = dot - pen, strict > keeps
//    the lowest slice; int8 key-pack: (dot << 8) - pen' with a plain max.
//    Nothing of the [B, tile] score block leaves the SM.
//  * Exact selection by filtering (ExactLists): every thread tests its own
//    distances against its row's current k-th value; only the few that pass
//    reach the row's owner thread, which inserts them in column order into a
//    list held in registers (k <= 16) or shared memory. On a tile's first
//    slice, when the lists are empty, a bound from the half-warp's minima
//    does the filtering.
#include "dtype.cuh"
#include "fma_tile.cuh"
#include "mma_tile.cuh"

#include <climits>
#include <math.h>
#include <type_traits>

namespace cuvs_tpu_torch {

constexpr int kMaxExactK = 64;
constexpr int kDsStride = kSliceRows + 1;    // row stride of a slice's distance block
constexpr size_t kMaxSmem = 232448;           // dynamic shared memory a block may take

// Score per (query, lane) running best. Float: score = dot - pen, strict >
// keeps the lowest slice. int8 chain: the same in int32. int8 key-pack: the
// slice id rides the low byte of (dot << 8) - pen', so a plain max suffices
// and the highest slice wins a tie, as in the TPU kernel.
constexpr int kFloatMode = 0, kChainMode = 1, kKeyPackMode = 2;

template <int kMode>
using BestT = typename std::conditional<kMode == kFloatMode, float, int>::type;

template <int kMode, typename Acc>
__device__ __forceinline__ void bin_init(BestT<kMode>& best, int& besti) {
  if constexpr (kMode == kFloatMode)
    best = -INFINITY;
  else
    best = INT_MIN;
  besti = 0;
}

template <int kMode, typename Acc>
__device__ __forceinline__ void bin_update(BestT<kMode>& best, int& besti, Acc acc,
                                           BestT<kMode> p, int s) {
  using Best = BestT<kMode>;
  if constexpr (kMode == kKeyPackMode) {
    const Best sc = static_cast<Best>(acc) * 256 - p;
    best = sc > best ? sc : best;
  } else {
    const Best sc = static_cast<Best>(acc) - p;
    if (sc > best) {
      best = sc;
      besti = s;
    }
  }
}

template <int kMode>
__device__ __forceinline__ void bin_store(float* out_v, uint8_t* out_i, size_t o,
                                          BestT<kMode> best, int besti) {
  if constexpr (kMode == kKeyPackMode) {
    out_v[o] = -static_cast<float>(best >> 8);
    out_i[o] = static_cast<uint8_t>(best & 255);
  } else {
    out_v[o] = -static_cast<float>(best);
    out_i[o] = static_cast<uint8_t>(besti);
  }
}

// ---------------------------------------------------------------------------
// Exact top-k: per-row lists in shared memory, filtered insertion per slice
// ---------------------------------------------------------------------------

// xnv: the column's squared norm, NaN for padded rows and columns past the
// tile (+inf distance)
__device__ __forceinline__ float exact_dist(float dot, float qnv, float xnv, int ip) {
  if (isnan(xnv)) return INFINITY;
  return ip ? -dot : fmaxf(qnv + xnv - 2.0f * dot, 0.f);
}

// A row's top-k list, ascending by (distance, column), kept by the one thread
// that owns the row. Candidates arrive in column order and enter only when
// strictly below the k-th value (kth), so ties keep the lower column, as the
// TPU kernel's first-occurrence argmax does. RegList holds up to kK entries in
// registers and inserts by a compare/select pass (no memory round trips);
// SmemList holds any k <= 64 in a column of shared memory.
template <int kK>
struct RegList {
  float v[kK];
  int c[kK];
  float kth = INFINITY;
  int k;

  __device__ explicit RegList(int k_) : k(k_) {
#pragma unroll
    for (int f = 0; f < kK; ++f) {
      v[f] = INFINITY;
      c[f] = 0;
    }
  }

  __device__ __forceinline__ void insert(float x, int col) {
#pragma unroll
    for (int f = kK - 1; f > 0; --f) {  // entries <= x stay ahead of it
      const bool up = v[f - 1] > x, here = !up && v[f] > x;
      c[f] = up ? c[f - 1] : (here ? col : c[f]);
      v[f] = up ? v[f - 1] : (here ? x : v[f]);
    }
    if (v[0] > x) {
      v[0] = x;
      c[0] = col;
    }
#pragma unroll
    for (int f = 0; f < kK; ++f) kth = f == k - 1 ? v[f] : kth;
  }

  __device__ __forceinline__ void write(float* out_v, int* out_i, size_t o, int base) const {
#pragma unroll
    for (int f = 0; f < kK; ++f)
      if (f < k) {
        out_v[o + f] = v[f];
        // the TPU kernel's masked argmax lands on column 0 once a tile has
        // no finite candidate left
        out_i[o + f] = v[f] == INFINITY ? base : c[f];
      }
  }
};

template <int kBQ>
struct SmemList {
  float* v;  // entry f at v[f * kBQ]
  int* c;
  float kth = INFINITY;
  int k;

  __device__ SmemList(float* lv, int* li, int k_) : v(lv + threadIdx.x), c(li + threadIdx.x), k(k_) {
    if (threadIdx.x < kBQ)
      for (int f = 0; f < k; ++f) {
        v[f * kBQ] = INFINITY;
        c[f * kBQ] = 0;
      }
  }

  __device__ void insert(float x, int col) {
    int pos = 0;  // entries <= x stay ahead of it; loads go 8 at a time
    for (int f0 = 0; f0 < k - 1; f0 += 8) {
      float u[8];
#pragma unroll
      for (int z = 0; z < 8; ++z) u[z] = f0 + z < k - 1 ? v[(f0 + z) * kBQ] : INFINITY;
#pragma unroll
      for (int z = 0; z < 8; ++z) pos += u[z] <= x;
    }
    for (int f1 = k - 1; f1 > pos; f1 -= 8) {  // shift [pos, k - 1) up by one
      float u[8];
      int w[8];
#pragma unroll
      for (int z = 0; z < 8; ++z)
        if (f1 - z > pos) {
          u[z] = v[(f1 - z - 1) * kBQ];
          w[z] = c[(f1 - z - 1) * kBQ];
        }
#pragma unroll
      for (int z = 0; z < 8; ++z)
        if (f1 - z > pos) {
          v[(f1 - z) * kBQ] = u[z];
          c[(f1 - z) * kBQ] = w[z];
        }
    }
    v[pos * kBQ] = x;
    c[pos * kBQ] = col;
    kth = v[(k - 1) * kBQ];
  }

  __device__ void write(float* out_v, int* out_i, size_t o, int base) const {
    for (int f = 0; f < k; ++f) {
      const float x = v[f * kBQ];
      out_v[o + f] = x;
      out_i[o + f] = x == INFINITY ? base : c[f * kBQ];
    }
  }
};

// The exact kernels' selection state in shared memory, after the mainloop's
// staging: the current slice's candidate distances ds[kBQ][kDsStride], the
// bitmask of the columns that passed, mask[kBQ][4], each row's k-th value
// kth[kBQ] as its owner last published it, and the room of SmemList lists,
// lv/li[k][kBQ].
//
// After each slice, and a barrier that ends the last slice's merges, every
// thread offers its own distances: one below its row's k-th value (as it
// stood before the slice) is written to ds and its bit set. After a second
// barrier, thread r merges row r's candidates into its list in column order.
// A list takes about k ln(tile_n / k) insertions over a tile (about 40 a row
// at k = 10, tile 2048), so an insertion must not wait on memory.
template <int kBQ>
struct ExactLists {
  static constexpr int kMaskWords = kSliceRows / 32;
  float* ds;
  unsigned* mask;
  float* kth_s;
  float* lv;  // SmemList room
  int* li;
  int k;

  static __host__ __device__ constexpr size_t smem_bytes(int k) {
    return (static_cast<size_t>(kBQ) * (kDsStride + kMaskWords + 1) +
            2 * static_cast<size_t>(k) * kBQ) * 4;
  }

  __device__ ExactLists(char* smem, int k_) : k(k_) {
    ds = reinterpret_cast<float*>(smem);
    mask = reinterpret_cast<unsigned*>(ds + kBQ * kDsStride);
    kth_s = reinterpret_cast<float*>(mask + kBQ * kMaskWords);
    lv = kth_s + kBQ;
    li = reinterpret_cast<int*>(lv + k * kBQ);
    for (int i = threadIdx.x; i < kBQ * kMaskWords; i += blockDim.x) mask[i] = 0;
    for (int i = threadIdx.x; i < kBQ; i += blockDim.x) kth_s[i] = INFINITY;
  }

  __device__ __forceinline__ float kth(int row) const { return kth_s[row]; }

  __device__ __forceinline__ void offer(int row, int c, float v, float thr) {
    if (v < thr) {
      ds[row * kDsStride + c] = v;
      atomicOr(mask + row * kMaskWords + c / 32, 1u << (c % 32));
    }
  }

  // An upper bound of the k-th smallest of a row held by a half-warp (k <= 16):
  // the k-th smallest of its 16 lanes' minima, which are k distinct entries
  // of the row. On a tile's first slice, when the list is still empty, it
  // keeps most of the slice out of the merge. +inf for k > 16.
  __device__ __forceinline__ float half_warp_bound(const float (&v)[8]) const {
    float x = v[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) x = fminf(x, v[j]);
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int size = 2; size <= 16; size *= 2)  // bitonic sort of the 16 minima
#pragma unroll
      for (int stride = size / 2; stride > 0; stride /= 2) {
        const float y = __shfl_xor_sync(0xffffffffu, x, stride);
        x = (((tx & stride) == 0) == ((tx & size) == 0)) ? fminf(x, y) : fmaxf(x, y);
      }
    const float b = __shfl_sync(0xffffffffu, x, (threadIdx.x & 16) | ((k - 1) & 15));
    return k <= 16 ? nextafterf(b, INFINITY) : INFINITY;  // v < bound <=> v <= b
  }

  // FmaTile layout: the 16 lanes of a half-warp hold row `row` at columns
  // tx + 16 j, so mask word w (columns 32 w + [0, 32)) is the half-warp's
  // ballots of j = 2 w and 2 w + 1, written by its lane tx = 0 alone.
  __device__ __forceinline__ void offer_row16(int row, const float (&v)[8], float thr) {
    const int tx = threadIdx.x % 16, half = threadIdx.x / 16 % 2;
    unsigned pass = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v[j] < thr) {
        ds[row * kDsStride + tx + 16 * j] = v[j];
        pass |= 1u << j;
      }
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) {
      const unsigned lo = __ballot_sync(0xffffffffu, (pass >> (2 * w)) & 1) >> (16 * half);
      const unsigned hi = __ballot_sync(0xffffffffu, (pass >> (2 * w + 1)) & 1) >> (16 * half);
      if (tx == 0) mask[row * kMaskWords + w] = (lo & 0xffffu) | (hi << 16);
    }
  }

  // Thread r's merge of row r's candidates of the slice whose column c is
  // col0 + c; the block is synchronised after the offers.
  template <typename List>
  __device__ __forceinline__ void merge(int col0, List& list) {
    const int row = threadIdx.x;
    if (row >= kBQ) return;
    for (int w = 0; w < kMaskWords; ++w) {
      unsigned m = mask[row * kMaskWords + w];
      if (!m) continue;
      mask[row * kMaskWords + w] = 0;
      do {
        const int c = w * 32 + __ffs(static_cast<int>(m)) - 1;
        m &= m - 1;
        const float v = ds[row * kDsStride + c];
        if (v < list.kth) list.insert(v, col0 + c);
      } while (m);
    }
    kth_s[row] = list.kth;
  }

  // Thread r's list to out[t, qb + r, :].
  template <typename List>
  __device__ __forceinline__ void store(const List& list, int qb, int B, int t, int base,
                                        float* out_v, int* out_i) const {
    const int row = threadIdx.x;
    if (row < kBQ && qb + row < B)
      list.write(out_v, out_i, (static_cast<size_t>(t) * B + qb + row) * k, base);
  }
};

// k <= kRegK: lists in the owner threads' registers.
constexpr int kRegK = 16;

// grid = n_tiles * n_qb blocks, query block fastest; out [n_tiles, B, k].
template <bool kRegs>
__global__ void __launch_bounds__(FmaTile<8>::kThreads, 1)
bf_topk_exact_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                         const float* __restrict__ qn, const float* __restrict__ xn, int B, int N,
                         int d, int k, int tile_n, int n_qb, int ip, int vec,
                         float* __restrict__ out_v, int* __restrict__ out_i) {
  using Tile = FmaTile<8>;
  constexpr int kBQ = Tile::kBQ;
  extern __shared__ __align__(128) char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  ExactLists<kBQ> lists(smem + Tile::smem_bytes(), k);
  typename std::conditional<kRegs, RegList<kRegK>, SmemList<kBQ>>::type list = [&] {
    if constexpr (kRegs)
      return RegList<kRegK>(k);
    else
      return SmemList<kBQ>(lists.lv, lists.li, k);
  }();

  const int t = blockIdx.x / n_qb, qb = (blockIdx.x % n_qb) * kBQ;
  const int base = t * tile_n, nk = Tile::n_chunks_k(d);
  const int n_slices = (tile_n + kSliceRows - 1) / kSliceRows;
  float qnv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qg = qb + Tile::row_of(i);
    qnv[i] = qg < B ? qn[qg] : 0.f;
  }
  float acc[8][Tile::kTN];
  auto q_row = [&](int r) -> const float* {
    return qb + r < B ? q + static_cast<size_t>(qb + r) * d : nullptr;
  };
  Tile::Rows rows;
  run_chunks<Tile::kStages, Tile::kGroup>(
      n_slices * nk,
      [&](int j, int slot) {
        if (j % nk == 0) {
          const int c0 = (j / nk) * kSliceRows;
          Tile::rows(rows, q_row, [&](int r) -> const float* {
            return c0 + r < tile_n && base + c0 + r < N ? x + static_cast<size_t>(base + c0 + r) * d
                                                        : nullptr;
          });
        }
        Tile::stage(ring + slot * Tile::kStageFloats, rows, j % nk, d, vec);
      },
      [&](int i, int slot) {
        const int kc = i % nk, c0 = (i / nk) * kSliceRows;
        if (kc == 0) {
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < Tile::kTN; ++b) acc[a][b] = 0.f;
        }
        Tile::compute(ring + slot * Tile::kStageFloats, acc);
        if (kc != nk - 1) return;
        __syncthreads();  // the last slice's merges are done with ds and kth
        float xnv[Tile::kTN];
#pragma unroll
        for (int b = 0; b < Tile::kTN; ++b) {
          const int c = c0 + Tile::col_of(b);
          xnv[b] = c < tile_n && base + c < N ? xn[base + c] : NAN;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          float v[Tile::kTN];
#pragma unroll
          for (int b = 0; b < Tile::kTN; ++b) v[b] = exact_dist(acc[a][b], qnv[a], xnv[b], ip);
          const float bound = c0 == 0 ? lists.half_warp_bound(v) : INFINITY;
          lists.offer_row16(Tile::row_of(a), v, fminf(lists.kth(Tile::row_of(a)), bound));
        }
        __syncthreads();
        lists.merge(base + c0, list);
      });
  lists.store(list, qb, B, t, base, out_v, out_i);
}

template <typename T, int kWM>
__global__ void __launch_bounds__(MmaTile<T, kWM>::kThreads, 1)
bf_topk_exact_mma_kernel(const T* __restrict__ q, const T* __restrict__ x,
                         const float* __restrict__ qn, const float* __restrict__ xn, int B, int N,
                         int d, int k, int tile_n, int n_qb, int ip, int vec,
                         float* __restrict__ out_v, int* __restrict__ out_i) {
  using Tile = MmaTile<T, kWM>;
  using Acc = typename Tile::Acc;
  constexpr int kBQ = Tile::kBQ;
  extern __shared__ __align__(128) char smem[];
  const int nk = Tile::n_chunks_k(d);
  char* qs = smem;
  char* ring = qs + static_cast<size_t>(kBQ) * nk * kChunkBytes;
  ExactLists<kBQ> lists(smem + Tile::smem_bytes(d), k);
  SmemList<kBQ> list(lists.lv, lists.li, k);

  const int t = blockIdx.x / n_qb, qb = (blockIdx.x % n_qb) * kBQ;
  const int base = t * tile_n;
  const int n_slices = (tile_n + kSliceRows - 1) / kSliceRows;
  float qnv[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qg = qb + Tile::row_of(mi, 2 * hf);
      qnv[mi][hf] = qg < B ? qn[qg] : 0.f;
    }
  Tile::stage_queries(qs, q, qb, B, d, vec);
  const T* rows[Tile::kRowsPerThread];
  Acc acc[2][4][4];
  run_chunks<Tile::kStages, Tile::kGroup>(
      n_slices * nk,
      [&](int j, int slot) {
        if (j % nk == 0) {
          const int c0 = (j / nk) * kSliceRows;
          Tile::rows(rows, [&](int r) -> const T* {
            return c0 + r < tile_n && base + c0 + r < N ? x + static_cast<size_t>(base + c0 + r) * d
                                                        : nullptr;
          });
        }
        Tile::stage_rows(ring + slot * Tile::kTileBytes, rows, j % nk, d, vec);
      },
      [&](int i, int slot) {
        const int kc = i % nk, c0 = (i / nk) * kSliceRows;
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
        __syncthreads();  // the last slice's merges are done with ds and kth
        float thr[2][2], xnv[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) thr[mi][hf] = lists.kth(Tile::row_of(mi, 2 * hf));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + Tile::col_of(ni, e);
            xnv[ni][e] = c < tile_n && base + c < N ? xn[base + c] : NAN;
          }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              lists.offer(Tile::row_of(mi, e), Tile::col_of(ni, e),
                          exact_dist(static_cast<float>(acc[mi][ni][e]), qnv[mi][e >> 1],
                                     xnv[ni][e & 1], ip),
                          thr[mi][e >> 1]);
        __syncthreads();
        lists.merge(base + c0, list);
      });
  lists.store(list, qb, B, t, base, out_v, out_i);
}

// ---------------------------------------------------------------------------
// Approximate per-lane-bin best
// ---------------------------------------------------------------------------

// grid = n_tiles * n_qb blocks, query block fastest; pen is [n_tiles, C, 128]
// (float or int32); out [n_tiles, B, 128].
template <typename T, int kWM, int kMode>
__global__ void __launch_bounds__(MmaTile<T, kWM>::kThreads, 1)
bf_topk_approx_mma_kernel(const T* __restrict__ q, const T* __restrict__ x,
                          const void* __restrict__ pen_raw, int B, int N, int d, int tile_n,
                          int n_qb, int vec, float* __restrict__ out_v,
                          uint8_t* __restrict__ out_i) {
  using Tile = MmaTile<T, kWM>;
  using Acc = typename Tile::Acc;
  using Best = BestT<kMode>;
  constexpr int kBQ = Tile::kBQ;
  extern __shared__ __align__(128) char smem[];
  const int nk = Tile::n_chunks_k(d);
  char* qs = smem;
  char* ring = qs + static_cast<size_t>(kBQ) * nk * kChunkBytes;

  const int t = blockIdx.x / n_qb, qb = (blockIdx.x % n_qb) * kBQ;
  const int C = tile_n / kSliceRows, base = t * tile_n;
  const Best* pen = static_cast<const Best*>(pen_raw) + static_cast<size_t>(t) * C * kSliceRows;
  Best best[2][4][4];
  int besti[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) bin_init<kMode, Acc>(best[mi][ni][e], besti[mi][ni][e]);
  Tile::stage_queries(qs, q, qb, B, d, vec);
  const T* rows[Tile::kRowsPerThread];
  Acc acc[2][4][4];
  run_chunks<Tile::kStages, Tile::kGroup>(
      C * nk,
      [&](int j, int slot) {
        if (j % nk == 0) {
          const int r0 = base + (j / nk) * kSliceRows;
          Tile::rows(rows, [&](int r) -> const T* {
            return r0 + r < N ? x + static_cast<size_t>(r0 + r) * d : nullptr;
          });
        }
        Tile::stage_rows(ring + slot * Tile::kTileBytes, rows, j % nk, d, vec);
      },
      [&](int i, int slot) {
        const int kc = i % nk, s = i / nk;
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
        const Best* pen_s = pen + static_cast<size_t>(s) * kSliceRows;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const Best p0 = pen_s[Tile::col_of(ni, 0)], p1 = pen_s[Tile::col_of(ni, 1)];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              bin_update<kMode>(best[mi][ni][e], besti[mi][ni][e], acc[mi][ni][e],
                                (e & 1) ? p1 : p0, s);
        }
      });
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qg = qb + Tile::row_of(mi, e);
      if (qg >= B) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        bin_store<kMode>(out_v, out_i,
                         (static_cast<size_t>(t) * B + qg) * kSliceRows + Tile::col_of(ni, e),
                         best[mi][ni][e], besti[mi][ni][e]);
    }
}

// float32 rows: exact fp32 products on the fp32 tile (4 x 8 per thread).
__global__ void __launch_bounds__(FmaTile<4>::kThreads, 1)
bf_topk_approx_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                          const float* __restrict__ pen, int B, int N, int d, int tile_n,
                          int n_qb, int vec, float* __restrict__ out_v,
                          uint8_t* __restrict__ out_i) {
  using Tile = FmaTile<4>;
  constexpr int kBQ = Tile::kBQ, kTM = 4;
  extern __shared__ __align__(128) char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int t = blockIdx.x / n_qb, qb = (blockIdx.x % n_qb) * kBQ;
  const int C = tile_n / kSliceRows, base = t * tile_n, nk = Tile::n_chunks_k(d);
  pen += static_cast<size_t>(t) * C * kSliceRows;
  float best[kTM][Tile::kTN];
  int besti[kTM][Tile::kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < Tile::kTN; ++b) bin_init<kFloatMode, float>(best[a][b], besti[a][b]);
  float acc[kTM][Tile::kTN];
  auto q_row = [&](int r) -> const float* {
    return qb + r < B ? q + static_cast<size_t>(qb + r) * d : nullptr;
  };
  Tile::Rows rows;
  run_chunks<Tile::kStages, Tile::kGroup>(
      C * nk,
      [&](int j, int slot) {
        if (j % nk == 0) {
          const int r0 = base + (j / nk) * kSliceRows;
          Tile::rows(rows, q_row, [&](int r) -> const float* {
            return r0 + r < N ? x + static_cast<size_t>(r0 + r) * d : nullptr;
          });
        }
        Tile::stage(ring + slot * Tile::kStageFloats, rows, j % nk, d, vec);
      },
      [&](int i, int slot) {
        const int kc = i % nk, s = i / nk;
        if (kc == 0) {
#pragma unroll
          for (int a = 0; a < kTM; ++a)
#pragma unroll
            for (int b = 0; b < Tile::kTN; ++b) acc[a][b] = 0.f;
        }
        Tile::compute(ring + slot * Tile::kStageFloats, acc);
        if (kc != nk - 1) return;
#pragma unroll
        for (int b = 0; b < Tile::kTN; ++b) {
          const float p = pen[static_cast<size_t>(s) * kSliceRows + Tile::col_of(b)];
#pragma unroll
          for (int a = 0; a < kTM; ++a) bin_update<kFloatMode>(best[a][b], besti[a][b], acc[a][b], p, s);
        }
      });
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int qg = qb + Tile::row_of(a);
    if (qg >= B) continue;
#pragma unroll
    for (int b = 0; b < Tile::kTN; ++b)
      bin_store<kFloatMode>(out_v, out_i,
                            (static_cast<size_t>(qg) + static_cast<size_t>(t) * B) * kSliceRows +
                                Tile::col_of(b),
                            best[a][b], besti[a][b]);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), long long blocks, int threads, size_t smem, cudaStream_t st,
           Args... args) {
  if (smem > kMaxSmem || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(static_cast<KArgs>(args)...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool vec_ok(const void* q, const void* x, int d) {
  return (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// The widest query block (kWM = 4, 2, 1) whose shared memory fits.
template <typename T, int kWM = 4>
int exact_mma(const void* q, const void* x, const float* qn, const float* xn, int B, int N, int d,
              int k, int tile_n, int n_tiles, int ip, float* out_v, int* out_i, cudaStream_t st) {
  using Tile = MmaTile<T, kWM>;
  const size_t smem = Tile::smem_bytes(d) + ExactLists<Tile::kBQ>::smem_bytes(k);
  if (smem > kMaxSmem) {
    if constexpr (kWM > 1)
      return exact_mma<T, kWM / 2>(q, x, qn, xn, B, N, d, k, tile_n, n_tiles, ip, out_v, out_i, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qb = (B + Tile::kBQ - 1) / Tile::kBQ;
  return launch(bf_topk_exact_mma_kernel<T, kWM>, static_cast<long long>(n_tiles) * n_qb,
                Tile::kThreads, smem, st, static_cast<const T*>(q), static_cast<const T*>(x), qn,
                xn, B, N, d, k, tile_n, n_qb, ip, static_cast<int>(vec_ok<T>(q, x, d)), out_v,
                out_i);
}

template <typename T, int kMode, int kWM = 4>
int approx_mma(const void* q, const void* x, const void* pen, int B, int N, int d, int tile_n,
               int n_tiles, float* out_v, uint8_t* out_i, cudaStream_t st) {
  using Tile = MmaTile<T, kWM>;
  const size_t smem = Tile::smem_bytes(d);
  if (smem > kMaxSmem) {
    if constexpr (kWM > 1)
      return approx_mma<T, kMode, kWM / 2>(q, x, pen, B, N, d, tile_n, n_tiles, out_v, out_i, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qb = (B + Tile::kBQ - 1) / Tile::kBQ;
  return launch(bf_topk_approx_mma_kernel<T, kWM, kMode>, static_cast<long long>(n_tiles) * n_qb,
                Tile::kThreads, smem, st, static_cast<const T*>(q), static_cast<const T*>(x), pen,
                B, N, d, tile_n, n_qb, static_cast<int>(vec_ok<T>(q, x, d)), out_v, out_i);
}

}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch;

extern "C" int cuvs_bf_topk_exact(int dtype, const void* q, const void* x, const float* qn,
                                  const float* xn, int B, int N, int d, int k, int tile_n,
                                  int n_tiles, int ip, float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kMaxExactK || tile_n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: {
      using Tile = FmaTile<8>;
      const int n_qb = (B + Tile::kBQ - 1) / Tile::kBQ;
      return launch(k <= kRegK ? bf_topk_exact_f32_kernel<true> : bf_topk_exact_f32_kernel<false>,
                    static_cast<long long>(n_tiles) * n_qb, Tile::kThreads,
                    Tile::smem_bytes() + ExactLists<Tile::kBQ>::smem_bytes(k), st,
                    static_cast<const float*>(q), static_cast<const float*>(x), qn, xn, B, N, d,
                    k, tile_n, n_qb, ip, static_cast<int>(vec_ok<float>(q, x, d)), out_v, out_i);
    }
    case kBF16:
      return exact_mma<__nv_bfloat16>(q, x, qn, xn, B, N, d, k, tile_n, n_tiles, ip, out_v, out_i,
                                      st);
    case kI8:
      return exact_mma<int8_t>(q, x, qn, xn, B, N, d, k, tile_n, n_tiles, ip, out_v, out_i, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cuvs_bf_topk_approx(int dtype, const void* q, const void* x, const void* pen,
                                   int B, int N, int d, int tile_n, int n_tiles, int key_pack,
                                   float* out_v, uint8_t* out_i, void* stream) {
  if (tile_n % kSliceRows || tile_n / kSliceRows > 256 || tile_n < kSliceRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: {
      using Tile = FmaTile<4>;
      const int n_qb = (B + Tile::kBQ - 1) / Tile::kBQ;
      return launch(bf_topk_approx_f32_kernel, static_cast<long long>(n_tiles) * n_qb,
                    Tile::kThreads, Tile::smem_bytes(), st, static_cast<const float*>(q),
                    static_cast<const float*>(x), static_cast<const float*>(pen), B, N, d, tile_n,
                    n_qb, static_cast<int>(vec_ok<float>(q, x, d)), out_v, out_i);
    }
    case kBF16:
      return approx_mma<__nv_bfloat16, kFloatMode>(q, x, pen, B, N, d, tile_n, n_tiles, out_v,
                                                   out_i, st);
    case kI8:
      return key_pack ? approx_mma<int8_t, kKeyPackMode>(q, x, pen, B, N, d, tile_n, n_tiles,
                                                         out_v, out_i, st)
                      : approx_mma<int8_t, kChainMode>(q, x, pen, B, N, d, tile_n, n_tiles,
                                                       out_v, out_i, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
