// CAGRA's beam search for Hopper (sm_90a): the whole step loop of a chunk of
// queries in one launch, one block a query.
//
// It replaces no Pallas kernel: the JAX package's beam search
// (cuvs_tpu/neighbors/cagra.py) is plain JAX. It was added because the
// port's PyTorch loop (neighbors/cagra.py, _beam_loop) launches about 25
// operations and waits for the host once a step, and writes its dedup as
// dense [B, W * deg, L] compares in device memory: the 138 steps of a
// 10,000-query SIFT-1M batch took about 425 ms on an H100, some 30 times what
// the bytes of the walk need.
//
// What it computes: the loop's steps, exactly (cuVS's search_single_cta
// walks the same list, one block a query). Per query, from its sorted list
// (distances list_v, ids list_id, kExplored in bit 30 of an expanded id):
//  1. the parents are the first W slots that are unexplored and finite; they
//     are marked explored and written to the visited ring at
//     (step * W + slot) % ring (a slot without a parent writes -2);
//  2. the parents' graph rows are the step's children (-1 without a parent);
//  3. a child is dropped if it is negative, equals a raw id on the list, an
//     earlier child of the step or an id in the ring (no ring: ring <= 0);
//  4. a kept child scores max(|q|^2 + |x|^2 - 2 q.x, 0) in min-space, or
//     -q.x for inner product, the products in f32 (a bf16 compute type
//     rounds both operands to bf16 first); a dropped child reads +inf;
//  5. the list becomes the first L of a stable sort of [list, children]:
//     ties keep list entries first, then children in (parent slot, edge)
//     order.
// A query stops once no unexplored finite entry is left, or after max_iter
// steps. The loop over a whole chunk leaves such a query unchanged in every
// further step, so stopping each query on its own gives the loop's lists.
//
// What bounds it on the card: bytes, gathered at random. A step of a
// SIFT-1M query reads a 256 B graph row and at most 64 rows of 512 B and
// their norms; a row costs 256 flops. Over a 10,000-query batch of 138 steps
// that is at most 46 GB: 14 ms at 3.35 TB/s, and less where the dedup drops
// a child before its row is read.
//
// The design (at that shape on an H100 80GB HBM3, 700 W: 14.3 ms for 12.5 ms
// of bytes, 87 % of the bound; 16.7 ms with 128 threads a query, 29.7 ms
// with 8 rows in flight, whose registers spilled):
//  * One block of 64 threads a query, sixteen blocks an SM (64 registers, no
//    spill). The list (twice: the merge writes the other copy), its raw ids,
//    the visited ring, the step's children and the query stay in shared
//    memory: 7.8 KB at itopk 128, degree 64, a 256-slot ring and d = 128.
//  * The dedup files the list's raw ids and the ring in a filter of 8192
//    bits each step; a child whose bit is clear is on neither (most are),
//    and one whose bit is set is held against them by a warp, 4 ids a lane.
//    Each child is held against the earlier children by its own thread.
//  * The kept children are dealt to the warps in turn. A warp reads a row 16
//    B a lane (a 512 B f32 row is one coalesced load), kInFlight rows at
//    once, and sums each dot product across its lanes.
//  * The merge: the children's keys ((order bits of the distance) << 32 |
//    position in [list, children]) are sorted by a bitonic network (one warp
//    up to 64 keys); every list entry and child then finds its rank in the
//    other sorted run by binary search and is written there if it ranks
//    below L. Keys are distinct, so the order is the stable sort's.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace cuvs_tpu_torch {
namespace {

typedef unsigned long long Key;

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;            // rows a warp reads at once
constexpr int kExplored = 1 << 30;      // the explored flag in a list id
constexpr int kMaxItopk = 512;          // cuVS's single-CTA limit
constexpr int kMaxCandidates = 1024;    // W * deg
constexpr int kMaxRing = 1024;
constexpr int kMaxDim = 1024;
constexpr int kNone = -2;               // a ring slot or pad that matches no id
constexpr int kFilterWords = 256;       // a filter of 8192 bits over the list's and ring's ids
constexpr unsigned kFull = 0xffffffffu;
constexpr Key kMaxKey = ~0ull;

struct Args {
  const void* rows;      // [n, d] f32 or bf16
  const float* norms;    // [n] squared norms of the f32 rows
  const int* graph;      // [n, deg]
  const float* queries;  // [B, d] f32, holding the compute type's values
  const float* qnorm;    // [B]
  float* list_v;         // [B, L]: the sorted list in, the final list out
  int* list_id;          // [B, L]
  int* counts;           // [B, 3] out: steps, expanded parents, scored children
  int n, d, deg, L, W, max_iter, ring, ip;
};

// The shared memory of a block, in 4-byte words after the keys.
struct Layout {
  int P, L4, V, V4, C, C4, D4, per_warp;
  __host__ __device__ Layout(int L, int W, int deg, int ring, int d) {
    C = W * deg;
    P = 2;
    while (P < C) P <<= 1;
    L4 = (L + 3) & ~3;
    V = ring > 0 ? ring : 0;
    V4 = (V + 3) & ~3;
    C4 = (C + 3) & ~3;
    D4 = (d + 3) & ~3;
    per_warp = (C + kWarps - 1) / kWarps;
  }
  // keys, then: compared ids (list, ring, children), query, list distances,
  // their order bits and ids twice, the filter, the children's distances,
  // drop flags and flagged children, the warps' rows, parents, the parents
  // found, the children flagged
  __host__ __device__ size_t bytes(int L, int W) const {
    const int words =
        L4 + V4 + C4 + D4 + 6 * L + kFilterWords + 3 * C + kWarps * per_warp + W + 2;
    return sizeof(Key) * P + 4 * static_cast<size_t>(words);
  }
};

// Order-preserving bits of a float, as pool_topk.cu: -0 ties +0, NaN last.
__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v == 0.0f) return 0x80000000u;
  if (isnan(v)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ Key key_of(uint32_t bits, int pos) {
  return (static_cast<Key>(bits) << 32) | static_cast<uint32_t>(pos);
}

// An id's bit in the filter.
__device__ __forceinline__ uint32_t filter_bit(int id) {
  return (static_cast<uint32_t>(id) * 2654435761u) >> 19;
}

__device__ __forceinline__ void file(unsigned* filter, int id) {
  const uint32_t b = filter_bit(id);
  atomicOr(filter + (b >> 5), 1u << (b & 31));
}

// bfloat16 round to nearest even, as torch's float -> bfloat16 -> float.
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return x;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// kVec elements of a row, read with one load (bf16 rows as uint16_t).
template <typename T, int kVec>
struct Chunk;

template <>
struct Chunk<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

template <>
struct Chunk<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ float at(int) const { return v; }
};

template <>
struct Chunk<uint16_t, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const uint16_t* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float at(int e) const {
    const uint32_t w = (e >> 1) == 0 ? v.x : (e >> 1) == 1 ? v.y : (e >> 1) == 2 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Chunk<uint16_t, 1> {
  uint16_t v;
  __device__ __forceinline__ void load(const uint16_t* p) { v = __ldg(p); }
  __device__ __forceinline__ float at(int) const {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};

// Sorts a[0, n) ascending, n a power of two: one warp (sync), or the block.
__device__ __forceinline__ void bitonic_step(Key* a, int t, int size, int stride) {
  const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
  const Key x = a[lo], y = a[hi];
  if ((x > y) == ((lo & size) == 0)) {
    a[lo] = y;
    a[hi] = x;
  }
}

__device__ void warp_sort(Key* a, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n / 2; t += 32) bitonic_step(a, t, size, stride);
      __syncwarp();
    }
}

__device__ void block_sort(Key* a, int n, int tid) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < n / 2; t += kThreads) bitonic_step(a, t, size, stride);
      __syncthreads();
    }
}

template <typename T, int kVec, bool kRound>
__global__ void __launch_bounds__(kThreads, 16) cagra_beam_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, W = a.W, deg = a.deg, d = a.d;
  const Layout lay(L, W, deg, a.ring, d);
  const int C = lay.C, P = lay.P, V = lay.V;
  Key* ckey = reinterpret_cast<Key*>(smem);            // the children's keys, sorted
  int* cmp = reinterpret_cast<int*>(ckey + P);         // raw list ids | ring | children
  int* ring = cmp + lay.L4;
  int* kids = ring + lay.V4;
  float* qs = reinterpret_cast<float*>(kids + lay.C4);  // the query
  float* lv = qs + lay.D4;                             // list distances, two copies
  uint32_t* lk = reinterpret_cast<uint32_t*>(lv + 2 * L);  // their order bits
  int* lid = reinterpret_cast<int*>(lk + 2 * L);       // list ids, two copies
  unsigned* filter = reinterpret_cast<unsigned*>(lid + 2 * L);
  float* cval = reinterpret_cast<float*>(filter + kFilterWords);  // the children's distances
  int* drop = reinterpret_cast<int*>(cval + C);
  int* flagged = drop + C;                             // children the filter may hold
  int* rows_of = flagged + C;                          // each warp's kept children
  int* par = rows_of + kWarps * lay.per_warp;          // the step's parents
  int* found_at = par + W;
  int* n_flagged = found_at + 1;

  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t qL = static_cast<size_t>(q) * L;
  const T* rows = static_cast<const T*>(a.rows);

  for (int j = tid; j < lay.L4; j += kThreads) {
    if (j < L) {
      const int id = a.list_id[qL + j];
      lv[j] = a.list_v[qL + j];
      lk[j] = order_bits(lv[j]);
      lid[j] = id;
      cmp[j] = id & (kExplored - 1);
    } else {
      cmp[j] = kNone;
    }
  }
  for (int j = tid; j < lay.V4; j += kThreads) ring[j] = kNone;
  for (int j = tid; j < kFilterWords; j += kThreads) filter[j] = 0;
  for (int j = C + tid; j < lay.C4; j += kThreads) kids[j] = kNone;
  for (int e = tid; e < d; e += kThreads) qs[e] = a.queries[static_cast<size_t>(q) * d + e];
  const float qn = a.qnorm[q];
  int cur = 0, step = 0, parents = 0, scored = 0;
  __syncthreads();

  for (; step < a.max_iter; ++step) {
    float* v = lv + cur * L;
    uint32_t* vk = lk + cur * L;
    int* id = lid + cur * L;
    // 1. warp 0 takes the first W unexplored finite slots as the parents; the
    // other warps file the list's raw ids in the filter
    if (warp == 0) {
      int found = 0;
      for (int j0 = 0; j0 < L && found < W; j0 += 32) {
        const int j = j0 + lane;
        const bool open = j < L && id[j] >= 0 && !(id[j] & kExplored) && isfinite(v[j]);
        const unsigned m = __ballot_sync(kFull, open);
        const int rank = found + __popc(m & below);
        if (open && rank < W) {
          par[rank] = id[j];
          id[j] |= kExplored;
        }
        found = min(W, found + __popc(m));
      }
      for (int s = found + lane; s < W; s += 32) par[s] = -1;
      __syncwarp();
      if (lane == 0) {
        *found_at = found;
        if (found > 0 && V > 0)
          for (int s = 0; s < W; ++s)
            ring[static_cast<int>((static_cast<long long>(step) * W + s) % V)] =
                par[s] >= 0 ? par[s] : kNone;
      }
    } else {
      for (int j = tid - 32; j < L; j += kThreads - 32)
        if (cmp[j] >= 0) file(filter, cmp[j]);
    }
    __syncthreads();
    const int found = *found_at;
    if (found == 0) break;
    parents += found;

    // 2. the parents' graph rows; ids outside [0, n) never match and are dropped
    for (int c = tid; c < C; c += kThreads) {
      const int slot = c / deg, p = par[slot];
      const int child = p >= 0 ? __ldg(a.graph + static_cast<size_t>(p) * deg + (c - slot * deg))
                               : -1;
      kids[c] = child;
      drop[c] = child < 0 || child >= a.n;
      cval[c] = INFINITY;
    }
    for (int j = tid; j < V; j += kThreads)
      if (ring[j] >= 0) file(filter, ring[j]);
    if (tid == 0) *n_flagged = 0;
    __syncthreads();

    // 3. drop a child that repeats an earlier child of the step; flag one
    // whose bit the filter holds, then a warp scans the list's raw ids and
    // the ring for each flagged child, 4 ids a lane at a time
    for (int c = tid; c < C; c += kThreads) {
      const int child = kids[c];
      if (child < 0 || child >= a.n) continue;
      bool hit = false;
      for (int i = 0; i < c; i += 4) {
        const int4 x = *reinterpret_cast<const int4*>(kids + i);
        hit |= (x.x == child) | (i + 1 < c && x.y == child) | (i + 2 < c && x.z == child) |
               (i + 3 < c && x.w == child);
      }
      const uint32_t b = filter_bit(child);
      if (hit) drop[c] = 1;
      else if ((filter[b >> 5] >> (b & 31)) & 1u) flagged[atomicAdd(n_flagged, 1)] = c;
    }
    __syncthreads();
    {
      const int A = lay.L4 + lay.V4, nf = *n_flagged;
      for (int f = warp; f < nf; f += kWarps) {
        const int c = flagged[f], child = kids[c];
        bool hit = false;
        for (int i = 4 * lane; i < A; i += 128) {
          const int4 x = *reinterpret_cast<const int4*>(cmp + i);
          hit |= (x.x == child) | (x.y == child) | (x.z == child) | (x.w == child);
        }
        if (__any_sync(kFull, hit) && lane == 0) drop[c] = 1;
      }
    }
    __syncthreads();

    // 4. score the kept children: the r-th kept child goes to warp r % kWarps
    {
      int* mine_at = rows_of + warp * lay.per_warp;
      int kept = 0, mine = 0;
      for (int i = 0; i < C; i += 32) {
        const int c = i + lane;
        const bool keep = c < C && !drop[c];
        const unsigned m = __ballot_sync(kFull, keep);
        const bool take = keep && (kept + __popc(m & below)) % kWarps == warp;
        const unsigned t = __ballot_sync(kFull, take);
        if (take) mine_at[mine + __popc(t & below)] = c;
        mine += __popc(t);
        kept += __popc(m);
      }
      scored += kept;
      __syncwarp();
      for (int r0 = 0; r0 < mine; r0 += kInFlight) {
        const int nr = min(kInFlight, mine - r0);
        int child[kInFlight];
        float acc[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          child[u] = u < nr ? kids[mine_at[r0 + u]] : 0;
          acc[u] = 0.0f;
        }
        const float nrm = lane < nr ? __ldg(a.norms + kids[mine_at[r0 + lane]]) : 0.0f;
        for (int ch = lane; ch < d / kVec; ch += 32) {
          Chunk<T, kVec> x[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
            if (u < nr) x[u].load(rows + static_cast<size_t>(child[u]) * d + ch * kVec);
          float qv[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) qv[e] = qs[ch * kVec + e];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u)
            if (u < nr) {
#pragma unroll
              for (int e = 0; e < kVec; ++e) {
                const float r = kRound ? round_bf16(x[u].at(e)) : x[u].at(e);
                acc[u] = fmaf(r, qv[e], acc[u]);
              }
            }
        }
        float dot = 0.0f;
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (u < nr) {
            float s = acc[u];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
            if (lane == u) dot = s;
          }
        if (lane < nr) {
          float dist = a.ip ? -dot : (qn + nrm) - 2.0f * dot;
          if (!a.ip && dist < 0.0f) dist = 0.0f;
          cval[mine_at[r0 + lane]] = dist;
        }
      }
    }
    __syncthreads();

    // 5. merge: sort the children's keys, then rank each side in the other
    if (P <= 64) {
      if (warp == 0) {
        for (int s = lane; s < P; s += 32)
          ckey[s] = s < C ? key_of(order_bits(cval[s]), L + s) : kMaxKey;
        __syncwarp();
        warp_sort(ckey, P, lane);
      }
    } else {
      for (int s = tid; s < P; s += kThreads)
        ckey[s] = s < C ? key_of(order_bits(cval[s]), L + s) : kMaxKey;
      __syncthreads();
      block_sort(ckey, P, tid);
    }
    __syncthreads();
    float* nv = lv + (cur ^ 1) * L;
    uint32_t* nk = lk + (cur ^ 1) * L;
    int* nid = lid + (cur ^ 1) * L;
    for (int j = tid; j < kFilterWords; j += kThreads) filter[j] = 0;
    for (int j = tid; j < L + C; j += kThreads) {
      Key k;
      int r, at;
      if (j < L) {  // a list entry: its slot + the children's keys below it
        k = key_of(vk[j], j);
        int lo = 0, hi = P;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ckey[mid] < k) lo = mid + 1;
          else hi = mid;
        }
        r = j + lo;
        at = j;
      } else {  // the (j - L)-th child by key: its rank + the list's keys below it
        k = ckey[j - L];
        int lo = 0, hi = L;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (key_of(vk[mid], mid) < k) lo = mid + 1;
          else hi = mid;
        }
        r = j - L + lo;
        at = static_cast<int>(static_cast<uint32_t>(k));  // L + the child's position
      }
      if (r < L) {
        const float val = at < L ? v[at] : cval[at - L];
        const int ident = at < L ? id[at] : kids[at - L];
        nv[r] = val;
        nk[r] = static_cast<uint32_t>(k >> 32);
        nid[r] = ident;
        cmp[r] = ident & (kExplored - 1);
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  const float* v = lv + cur * L;
  const int* id = lid + cur * L;
  for (int j = tid; j < L; j += kThreads) {
    a.list_v[qL + j] = v[j];
    a.list_id[qL + j] = id[j];
  }
  if (tid == 0) {
    int* out = a.counts + 3 * static_cast<size_t>(q);
    out[0] = step;
    out[1] = parents;
    out[2] = scored;
  }
}

}  // namespace
}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch;

// rows [n, d] (dtype: DType kF32 or kBF16; round_bf16: f32 rows scored as
// bf16), norms [n] f32, graph [n, deg] int32, queries [B, d] f32, qnorm [B]
// f32; list_v [B, L] f32 and list_id [B, L] int32 hold each query's sorted
// list and are overwritten by its final list; writes counts [B, 3] int32
// (steps, expanded parents, scored children). ring <= 0: no visited ring.
// Needs n < 2^30, d <= kMaxDim, L <= kMaxItopk, W * deg <= kMaxCandidates,
// ring <= kMaxRing.
extern "C" int cuvs_cagra_beam(int dtype, int round_bf16, const void* rows, const float* norms,
                               const int* graph, const float* queries, const float* qnorm,
                               float* list_v, int* list_id, int* counts, int n, int d, int deg,
                               int B, int L, int W, int max_iter, int ring, int ip,
                               void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || (round_bf16 && dtype != kF32) || n < 1 ||
      n >= kExplored || d < 1 || d > kMaxDim || deg < 1 || B < 0 || L < 1 || L > kMaxItopk ||
      W < 1 || static_cast<long long>(W) * deg > kMaxCandidates || ring > kMaxRing ||
      max_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Layout lay(L, W, deg, ring, d);
  const size_t smem = lay.bytes(L, W);
  const size_t esize = dtype == kF32 ? 4 : 2;
  const bool vec = reinterpret_cast<uintptr_t>(rows) % 16 == 0 && (d * esize) % 16 == 0;
  void (*kernel)(const Args);
  if (dtype == kBF16)
    kernel = vec ? &cagra_beam_kernel<uint16_t, 8, false>
                 : &cagra_beam_kernel<uint16_t, 1, false>;
  else if (round_bf16)
    kernel = vec ? &cagra_beam_kernel<float, 4, true> : &cagra_beam_kernel<float, 1, true>;
  else
    kernel = vec ? &cagra_beam_kernel<float, 4, false> : &cagra_beam_kernel<float, 1, false>;
  if (smem > 48 * 1024) {  // above the default limit of dynamic shared memory
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const Args a{rows, norms, graph, queries, qnorm, list_v, list_id, counts,
               n, d, deg, L, W, max_iter, ring, ip};
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
