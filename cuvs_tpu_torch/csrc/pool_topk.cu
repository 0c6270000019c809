// Pool top-k for Hopper (sm_90a): the pool merge of the fused IVF searches.
//
// It replaces no Pallas kernel: the JAX package merges the per-probe pools
// with lax.top_k / lax.approx_min_k in XLA. It was added because the merge
// (a copy of the whole pool, a gather of it per query, a full segmented sort
// of p*F keys to keep `fetch`) was 36-39 % of a 10,000-query IVF batch on
// an H100, where the scan kernels are the rest.
//
// What it computes, per query q: the `fetch` smallest entries, best first, of
// the virtual pool pv[q, j*F + c] = pool[pair_tile[q,j], pair_slot[q,j], c]
// (+ offs[q,j]), a dropped pair (pair_tile outside [0, n_tiles)) reading
// +inf, with ties to the lower column: what a stable ascending sort of pv
// keeps. -0 ties +0 and a NaN sorts after +inf, as the stable sort orders
// them. pv is never formed.
//
// What bounds it on the card: bytes. Every entry of the probed pairs' pool
// rows is read once, nq*p*F*4 bytes (2.05 GB for 10,000 queries at 200
// probes and F = 256: 0.61 ms at 3.35 TB/s); the outputs are nq*fetch*12.
//
// The design (the filtered warp sort of cuVS's select_k, warpsort):
//  * One warp per query, one warp a block, 32 blocks an SM (64 registers, no
//    spill). The warp streams its pair rows, F contiguous floats each, 16
//    bytes a lane a step, four steps in flight a lane; the rows' pool offsets
//    and per-pair offsets are staged in shared memory 256 pairs at a time, so
//    no load waits on another. One warp a query spends the least on
//    filling queues and merging them: on an H100, 8 warps a query took
//    1.4-3.1 x as long (real pools at SIFT, DEEP and CAGRA build shapes).
//  * A key is the value's order bits over its column (64 bits), so every key
//    is distinct and one unsigned compare orders by value, then column: the
//    stable sort's ties, exactly, from non-stable networks.
//  * The warp keeps the K = next pow2 >= fetch best keys it has seen, sorted,
//    in shared memory, and their K-th key as a threshold. A key below it goes
//    to a buffer of max(K, 256) keys (ballot + prefix count); when the buffer
//    may overflow on the next step, the warp sorts it (bitonic network) and
//    merges it into its queue: min(queue[i], buf[K-1-i]) is bitonic and
//    holds the K best, which a bitonic merge sorts. Once the threshold
//    settles, few keys pass, and the kernel runs at the rate it reads.
//    fetch goes up to 4096 (the scan's widest bins, cap 32 x 128): 64 KB of
//    shared memory a warp at K = 4096, 4 KB at K <= 256.
//  * At the end the warp writes the first `fetch` keys: the column, and the
//    value read again from the pool (+ offset), bit for bit the entry that
//    was ranked.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace cuvs_tpu_torch {
namespace {

typedef unsigned long long Key;

constexpr int kStep = 128;           // entries a warp loads a step: 32 lanes x float4
constexpr int kUnroll = 4;           // steps a lane keeps in flight
constexpr int kBuf = 256;            // a warp's candidate buffer at K <= 256, keys
constexpr int kMetaRows = 256;       // pairs whose row and offset the warp stages at once
constexpr int kMaxK = 4096;          // largest fetch
constexpr Key kMaxKey = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving bits of a float: unsigned order equals the stable sort's
// order of values; -0 maps to +0 and every NaN above +inf.
__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v == 0.0f) return 0x80000000u;
  if (isnan(v)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Sorts a[0, n) ascending, n a power of two; the warp's 32 lanes together.
__device__ void warp_sort(Key* a, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const Key x = a[lo], y = a[hi];
        if ((x > y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncwarp();
    }
}

// q[0, K) and b[0, >= K) ascending: q becomes the K smallest of both, ascending.
__device__ void warp_merge(Key* q, const Key* b, int K, int lane) {
  for (int i = lane; i < K; i += 32) {
    const Key y = b[K - 1 - i];
    if (y < q[i]) q[i] = y;
  }
  __syncwarp();
  for (int stride = K >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < K / 2; t += 32) {
      const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
      const Key x = q[lo], y = q[hi];
      if (x > y) {
        q[lo] = y;
        q[hi] = x;
      }
    }
    __syncwarp();
  }
}

// Merges the warp's cnt buffered keys into its queue; returns the queue's K-th key.
__device__ __noinline__ Key flush(Key* queue, Key* buf, int cnt, int K, int lane) {
  int n = K;
  while (n < cnt) n <<= 1;
  for (int i = cnt + lane; i < n; i += 32) buf[i] = kMaxKey;
  __syncwarp();
  warp_sort(buf, n, lane);
  warp_merge(queue, buf, K, lane);
  return queue[K - 1];
}

template <bool kOffs>
__global__ void __launch_bounds__(32, 32)
    pool_topk_kernel(const float* __restrict__ pool, int n_tiles, int M, int F,
                     const int* __restrict__ pair_tile, const int* __restrict__ pair_slot,
                     const float* __restrict__ offs, int p, int fetch, int K,
                     float* __restrict__ out_v, long long* __restrict__ out_l) {
  extern __shared__ Key queue[];     // K best keys, then the buffer of max(K, kBuf) keys
  __shared__ int row_of[kMetaRows];  // the pair's pool row, tile * M + slot; -1: dropped
  __shared__ float off_of[kMetaRows];
  const int q = blockIdx.x, lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  Key* buf = queue + K;
  const int buf_keys = K > kBuf ? K : kBuf;
  for (int i = lane; i < K; i += 32) queue[i] = kMaxKey;
  Key thr = kMaxKey;
  int cnt = 0;  // keys in the buffer, the same in every lane
  const int steps = F / kStep;
  const int* tiles = pair_tile + static_cast<size_t>(q) * p;
  const int* slots = pair_slot + static_cast<size_t>(q) * p;

  for (int j0 = 0; j0 < p; j0 += kMetaRows) {
    const int rows = min(kMetaRows, p - j0);
    __syncwarp();  // the last chunk's rows are read
    for (int r = lane; r < rows; r += 32) {
      const int t = tiles[j0 + r], s = slots[j0 + r];
      row_of[r] = (t >= 0 && t < n_tiles && s >= 0 && s < M) ? t * M + s : -1;
      if (kOffs) off_of[r] = offs[static_cast<size_t>(q) * p + j0 + r];
    }
    __syncwarp();
    const int items = rows * steps;
    int r = 0, s = 0;  // the next item's row and step
    for (int it = 0; it < items; it += kUnroll) {
      float4 v[kUnroll];
      float o[kUnroll];
      int col[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        col[u] = -1;
        if (it + u < items) {
          const int row = row_of[r], c = s * kStep + lane * 4;
          col[u] = (j0 + r) * F + c;
          o[u] = kOffs ? off_of[r] : 0.0f;
          v[u] = row < 0 ? make_float4(INFINITY, INFINITY, INFINITY, INFINITY)
                         : __ldcs(reinterpret_cast<const float4*>(
                               pool + static_cast<size_t>(row) * F + c));
          if (++s == steps) {
            s = 0;
            ++r;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (col[u] < 0) break;  // the same in every lane
        const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        Key key[4];
        bool pass[4], any = false;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float x = kOffs ? e[m] + o[u] : e[m];
          key[m] = (static_cast<Key>(order_bits(x)) << 32) | static_cast<uint32_t>(col[u] + m);
          pass[m] = key[m] < thr;
          any |= pass[m];
        }
        if (__any_sync(kFull, any)) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const unsigned hit = __ballot_sync(kFull, pass[m]);
            if (pass[m]) buf[cnt + __popc(hit & below)] = key[m];
            cnt += __popc(hit);
          }
          if (cnt > buf_keys - kStep) {  // the next step could overflow the buffer
            __syncwarp();
            thr = flush(queue, buf, cnt, K, lane);
            cnt = 0;
          }
        }
      }
    }
  }
  if (cnt > 0) {
    __syncwarp();
    flush(queue, buf, cnt, K, lane);
  }
  for (int i = lane; i < fetch; i += 32) {
    const uint32_t col = static_cast<uint32_t>(queue[i]);
    const int j = static_cast<int>(col / F), c = static_cast<int>(col - j * F);
    const int t = tiles[j], s = slots[j];
    float x = INFINITY;
    if (t >= 0 && t < n_tiles && s >= 0 && s < M) {
      x = pool[(static_cast<size_t>(t) * M + s) * F + c];
      if (kOffs) x += offs[static_cast<size_t>(q) * p + j];
    }
    out_v[static_cast<size_t>(q) * fetch + i] = x;
    out_l[static_cast<size_t>(q) * fetch + i] = col;
  }
}

}  // namespace
}  // namespace cuvs_tpu_torch

using namespace cuvs_tpu_torch;

// pool [n_tiles, M, F] f32, pair_tile / pair_slot [nq, p] int32, offs [nq, p]
// f32 or null; writes out_v [nq, fetch] f32 and out_l [nq, fetch] int64 (the
// pool columns j*F + c). Needs 1 <= fetch <= min(kMaxK, p*F), F a multiple of
// 128, p*F and n_tiles*M below 2^31, and a 16-byte aligned pool.
extern "C" int cuvs_pool_topk(const float* pool, int n_tiles, int M, int F, const int* pair_tile,
                              const int* pair_slot, const float* offs, int nq, int p, int fetch,
                              float* out_v, long long* out_l, void* stream) {
  if (F <= 0 || F % kStep || p <= 0 || nq < 0 || fetch < 1 || fetch > kMaxK ||
      static_cast<long long>(p) * F >= INT_MAX || fetch > p * F ||
      static_cast<long long>(n_tiles) * M >= INT_MAX ||
      reinterpret_cast<uintptr_t>(pool) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  int K = 1;
  while (K < fetch) K <<= 1;
  const size_t smem = static_cast<size_t>(K + (K > kBuf ? K : kBuf)) * sizeof(Key);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = offs ? pool_topk_kernel<true> : pool_topk_kernel<false>;
  if (smem > 48 * 1024) {  // above the default limit of dynamic shared memory
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<nq, 32, smem, st>>>(pool, n_tiles, M, F, pair_tile, pair_slot, offs, p, fetch, K,
                               out_v, out_l);
  return static_cast<int>(cudaGetLastError());
}
