// Fused quantized-code IVF scan (IVF-PQ and IVF-RaBitQ) for Hopper (sm_90a):
// the scan kernel and what its two sources share. pq_scan.cu holds the
// shallow bins (cap <= 2, the main path's k <= 64), the int8 table's scale
// pass and the C entry point; pq_scan_deep.cu the deep bins (cap 3-32: k > 64,
// CAGRA's IVF-PQ graph build). They are two sources so that nvcc builds them
// in parallel processes.
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
// What bounds it on the card. At 1M rows, 4096 queries and 50 probes a batch
// scores about 2e8 (slot, row) pairs, each through S table entries picked at
// random within a subspace: 1.3e10 lookups for PQ (pq_dim 64), 2.6e10 for
// RaBitQ (128 dims), and builds a 16384-entry table for each of its 3.4e5
// slots. The fp32 bound (one add per lookup, the tables' multiply-adds) is
// 0.6-0.8 ms; issue alone is >= 2 instructions per lookup (widen a bf16
// entry, add), about 0.9 ms (PQ) and 1.8 ms (RaBitQ) on 132 SMs. The first
// version spent ~10-15 instructions per lookup, each slot decoding every row
// again and reading its own table one 2-byte entry at a time, and ran at
// 2-3% of the fp32 bound. Now (H100, PQ with a bf16 table, ~10.5 ms) about a
// third is the table build, latency-bound because a 128 KB table leaves one
// block per SM, and two thirds the scan, where a warp's 32 random 8-byte
// lookups into a 2 KB subspace row meet ~5-way bank conflicts (RaBitQ's
// 128-byte rows do not). Deep bins add the chain: at cap 7 over a list of
// ~8 slices nearly every score is inserted, kDepth steps each.
//
// The design:
//  * Slot-interleaved tables, decode once per row. A block owns kSlots slots
//    of one tile; entry e of all its slots sits in one 16-, 8-, 4- or 2-byte
//    word, lut[e * kSlots + g], so a window row's codes are decoded once for
//    the block and one shared-memory load per code returns the entry for
//    every slot, into one accumulator per slot. Decode and address work and
//    the number of loads drop kSlots-fold. A code >= book selects entry
//    S*book, a zero word: adding +0 leaves any sum unchanged, so no branch is
//    needed. Slots per block: each source's plan.
//  * The table build reads each codebook row 4 entries at a time (8 bytes),
//    reuses each query value for the 4, and writes the block's interleaved
//    words 16 bytes at a time. int8 entries round v / scale by a multiply
//    with the reciprocal, and by the IEEE division only near a half-integer,
//    where the two could round apart.
//  * Codes: PQ's 8-bit and RaBitQ's 3-bit codes with a full book decode
//    with compile-time shifts (one funnel shift where a code straddles two
//    words) and index the table with no book test; other widths and books
//    go through a 64-bit bit buffer.
//  * Rows in flight: kT = 4 threads per window row (512 per block), thread
//    j summing code share j of the row for every slot: the periods j, j + 4,
//    ... (a period is the fewest codes that fill whole words: 4 of 8 bits,
//    32 of 3), each in code order. The four partial sums meet in shared
//    memory and are added in the order j = 0..3. The order depends on S and
//    the width alone, and the plain version sums in it. The code words of
//    each 128-row slice are staged by cp.async into a two-stage ring while
//    the last slice is scored (slice 0 while the table is built): one
//    barrier per slice, and a slice's epilogue runs after the next slice's
//    barrier.
//  * The chain stays whole. Thread j keeps the bins of lane `lane` for slots
//    j, j + 4, ... and inserts each slice in order, as the TPU kernel does.
//    Splitting a window's slices between thread groups and merging their
//    bins would not give the chain's result: at exact ties the chain is not
//    a stable top-cap (x at slice 3, x at slice 5, then v > x at slice 7
//    leaves [v@7, x@5], the displaced x@3 dropped at the equal x@5), so no
//    merge of per-group lists reproduces it.
//  * Bins in registers at a compile-time depth kDepth >= cap. The strict->
//    chain is prefix-stable: level r depends only on the inserted values and
//    levels < r, so a kDepth-deep chain cut to its first `cap` levels is the
//    cap-deep chain. Five depth classes (2 in pq_scan.cu for cap 1-2; 4, 8,
//    16, 32 in pq_scan_deep.cu) serve every cap with fully unrolled chains:
//    no bin is indexed at run time, none sits in local memory. Slice ids
//    (< 256) are packed four to a register. The bins are set after the table
//    is built, so they do not add to the build's registers, which set the
//    kernel's peak.
//  * Sums: table entries are f32 sums of exact bf16 products in row order.
//    int8 tables sum in exact int32, then times the scale; bf16 tables sum
//    in f32 in the order above. The epilogue uses __fmul_rn/__fadd_rn, so no
//    fused multiply-add changes a rounding: pools bit-identical to the plain
//    version's but where an int8 entry's lut/scale sits on a rounding
//    boundary.
//  * The int8 table's scale is the max |lut| over all M slots of a tile,
//    across blocks: a first kernel (pq_lut_absmax_kernel, pq_scan.cu)
//    computes it per tile with the same sums, without storing a table.
#pragma once

#include "bins.cuh"
#include "mma_tile.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cuvs_tpu_torch {
namespace pq {

constexpr int kLanes = 128;      // threads per group = lane bins = rows per slice
constexpr int kMaxGroups = 8;    // most slots per scan block
constexpr int kT = 4;            // threads per window row of a scan block
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
  int vec;        // codes and n_pad allow 16-byte copies of 4 rows
  int book_log2;  // log2(book) for a power-of-two book, else -1
  int period, period_words;  // the fewest codes that fill whole words, and those words
  float* absmax;  // [n_tiles] max |lut| per tile (int8 mode)
  float* out_v;
  uint8_t* out_i;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared memory of a scan block of G slots: the slots' query rows, the
// interleaved table (+ one zero entry), a two-stage ring of one slice's code
// words, two stages of partial sums.
inline size_t scan_smem(int G, const Args& a) {
  return align16(static_cast<size_t>(G) * a.dp * 4) +
         align16((static_cast<size_t>(a.S) * a.book + 1) * G * (a.int8_mode ? 1 : 2)) +
         2 * static_cast<size_t>(a.nw) * kLanes * 4 + 2 * static_cast<size_t>(kT) * G * kLanes * 4;
}

// What one block may take: all of an SM's shared memory, or half of it less
// the 1 KB per block the system keeps, so that two blocks share the SM.
inline size_t smem_limit(bool two) {
  return two ? static_cast<size_t>(kSmemMax) / 2 - 1024 : static_cast<size_t>(kSmemMax);
}

__device__ __forceinline__ int tile_slices(const Args& a, int t, int* cc_lo) {
  const int l = a.lo[t], h = l + a.sizes[t];
  *cc_lo = h > l ? l / kLanes : 0;
  return h > l ? min((h + kLanes - 1) / kLanes, a.W / kLanes) : 0;
}

// Query rows of the block's slots into qs[G][dp] as f32 (bf16 values): the
// slot's row, or zeros for an empty slot, minus the tile's center in mode pq
// with L2 (a bf16 - bf16 subtraction rounded to bf16).
__device__ inline void load_qrows(const Args& a, int t, int m0, int G, float* qs) {
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

// visit(e, acc) for every table entry e < n_e of this thread (e = threadIdx.x
// + i * blockDim.x), acc[g] = sum over the column's pq_len nonzero rows of
// qs[g][j] * cb[j][e] for the block's slots g < G, in row order (each product
// of two bf16 values is exact in f32); entries e >= S*book are zero. The
// codebook is read kB entries x 2 rows at a time, so that many loads are in
// flight together: one entry at a time, every warp of the block would wait
// out an L2 round trip per entry.
template <int kG, typename Visit>
__device__ __forceinline__ void lut_entries(const Args& a, const float* qs, int G, int n_e,
                                            Visit visit) {
  constexpr int kB = 32 / kG < 4 ? 4 : (32 / kG > 8 ? 8 : 32 / kG), kRows = 2;
  const int SB = a.S * a.book;
  for (int e0 = threadIdx.x; e0 < n_e; e0 += kB * blockDim.x) {
    float acc[kB][kG];
    int j0[kB], L[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int e = e0 + b * blockDim.x;
      j0[b] = (a.book_log2 >= 0 ? e >> a.book_log2 : e / a.book) * a.pq_len;
      L[b] = e < SB ? max(0, min(a.pq_len, a.dp - j0[b])) : 0;
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[b][g] = 0.f;
    }
    for (int l0 = 0; l0 < a.pq_len; l0 += kRows) {
      float c[kB][kRows];
#pragma unroll
      for (int b = 0; b < kB; ++b)
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          c[b][u] = l0 + u < L[b]
                        ? __bfloat162float(__ldg(a.cb + static_cast<size_t>(j0[b] + l0 + u) * SB +
                                                 e0 + b * blockDim.x))
                        : 0.f;
#pragma unroll
      for (int b = 0; b < kB; ++b)
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (l0 + u >= L[b]) continue;
          const int j = j0[b] + l0 + u;
#pragma unroll
          for (int g = 0; g < kG; ++g)
            if (g < G) acc[b][g] = fmaf(qs[g * a.dp + j], c[b][u], acc[b][g]);
        }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b)
      if (e0 + b * blockDim.x < n_e) visit(e0 + b * blockDim.x, acc[b]);
  }
}

// The same entries four at a time where book % 4 == 0: thread i builds
// entries 4i .. 4i + 3 of one subspace, so one 8-byte load per codebook row
// gives all four columns and each query value, read once, feeds four
// multiply-adds per slot. visit4(e0, acc[4][kG]) for each quad e0 < S*book,
// the same sums in the same order as lut_entries.
template <int kG, typename Visit>
__device__ __forceinline__ void lut_quads(const Args& a, const float* qs, int G, Visit visit4) {
  constexpr int kB = kG >= 8 ? 1 : 2;  // quads per thread in flight
  const int SB = a.S * a.book, n4 = SB / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kB * blockDim.x) {
    float acc[kB][4][kG];
    int j0[kB], L[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int e0 = 4 * (i0 + b * blockDim.x);
      j0[b] = (a.book_log2 >= 0 ? e0 >> a.book_log2 : e0 / a.book) * a.pq_len;
      L[b] = e0 < SB ? max(0, min(a.pq_len, a.dp - j0[b])) : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int g = 0; g < kG; ++g) acc[b][c][g] = 0.f;
    }
    for (int l = 0; l < a.pq_len; ++l) {
      uint2 w[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b)
        w[b] = l < L[b] ? __ldg(reinterpret_cast<const uint2*>(
                              a.cb + static_cast<size_t>(j0[b] + l) * SB + 4 * (i0 + b * blockDim.x)))
                        : make_uint2(0, 0);
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (l >= L[b]) continue;
        const float c[4] = {__uint_as_float(w[b].x << 16), __uint_as_float(w[b].x & 0xffff0000u),
                            __uint_as_float(w[b].y << 16), __uint_as_float(w[b].y & 0xffff0000u)};
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (g >= G) continue;
          const float qv = qs[g * a.dp + j0[b] + l];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[b][k][g] = fmaf(qv, c[k], acc[b][k][g]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b)
      if (i0 + b * blockDim.x < n4) visit4(4 * (i0 + b * blockDim.x), acc[b]);
  }
}

// rint(v / ls) as the plain version computes it (an IEEE division, then
// round half to even), for |v / ls| <= 127: v * (1 / ls) lies within a few ulp
// of the true quotient, so it rounds to the same integer unless it is near a
// half-integer, and only then is the division taken.
__device__ __forceinline__ int8_t quantize(float v, float ls, float inv_ls) {
  float y = v * inv_ls;
  if (fabsf(fabsf(y - truncf(y)) - 0.5f) < 1e-3f) y = __fdiv_rn(v, ls);
  return static_cast<int8_t>(rintf(y));
}

// Store kWords words to 16-byte aligned shared memory, 16 bytes at a time
// where they allow.
template <int kWords>
__device__ __forceinline__ void store_words(void* dst, const uint32_t (&w)[kWords]) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords; i += 4)
      reinterpret_cast<uint4*>(dst)[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  } else if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// Table entries e0 .. e0 + 3 of the block's kSlots slots, interleaved, as
// words: bf16 rounded, or int8 at scale ls (|lut/ls| <= 127: no clip needed).
template <typename T, int kSlots>
__device__ __forceinline__ void store_quad(T* lut, int e0, const float (&acc)[4][kSlots], float ls,
                                           float inv_ls) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // values per word
  constexpr int kWords = 4 * kSlots / kPer;
  uint32_t w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = 0;
#pragma unroll
  for (int k = 0; k < 4 * kSlots; ++k) {
    const float v = acc[k / kSlots][k % kSlots];
    uint32_t bits;
    if constexpr (sizeof(T) == 1)
      bits = static_cast<uint8_t>(quantize(v, ls, inv_ls));
    else
      bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    w[k / kPer] |= bits << (32 / kPer * (k % kPer));
  }
  store_words<kWords>(lut + static_cast<size_t>(e0) * kSlots, w);
}

// ---------------------------------------------------------------------------
// Interleaved table entries
// ---------------------------------------------------------------------------

template <int kWords>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[kWords]) {
  if constexpr (kWords == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

// acc[g] += slot g's value of interleaved entry e, for every slot of the block.
// bf16 -> f32 is exact (the bf16 bits are the f32's high half).
template <int kSlots>
__device__ __forceinline__ void add_entry(const __nv_bfloat16* lut, int e, float (&acc)[kSlots]) {
  if constexpr (kSlots == 1) {
    acc[0] = __fadd_rn(acc[0], __bfloat162float(lut[e]));
  } else {
    constexpr int kW = kSlots / 2;
    uint32_t w[kW];
    load_words<kW>(reinterpret_cast<const uint32_t*>(lut) + e * kW, w);
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      acc[2 * i] = __fadd_rn(acc[2 * i], __uint_as_float(w[i] << 16));
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u));
    }
  }
}
template <int kSlots>
__device__ __forceinline__ void add_entry(const int8_t* lut, int e, int (&acc)[kSlots]) {
  if constexpr (kSlots < 4) {
#pragma unroll
    for (int g = 0; g < kSlots; ++g) acc[g] += lut[e * kSlots + g];
  } else {
    constexpr int kW = kSlots / 4;
    uint32_t w[kW];
    load_words<kW>(reinterpret_cast<const uint32_t*>(lut) + e * kW, w);
#pragma unroll
    for (int i = 0; i < kW; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[4 * i + b] += static_cast<int8_t>(w[i] >> (8 * b));
  }
}

// ---------------------------------------------------------------------------
// Scan
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }

// T: table type (bf16, or int8 with int8_mode). kSlots slots per block.
// kDepth: the bins' compile-time depth, >= a.cap; the first a.cap levels are
// written out. kBits > 0: compile-time code width and book == 2^kBits; 0: any
// width and book, through a 64-bit bit buffer. kMinBlocks: blocks per SM the
// registers must allow.
// n_tiles * ceil(M / kSlots) blocks, kT * 128 threads: thread (j, lane)
// sums code share j of window row `lane` of each slice for every slot, and
// keeps the bins of lane `lane` of slots j, j + kT, ...
// Shared memory (scan_smem): the slots' query rows, the interleaved table
// (+ one zero entry), a two-stage ring of one slice's code words
// sw[stage][w][lane], and two stages of partial sums part[stage][j][g][lane].
template <typename T, int kSlots, int kDepth, int kBits, int kMinBlocks>
__global__ void __launch_bounds__(kLanes* kT, kMinBlocks) pq_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  constexpr int kOwn = (kSlots + kT - 1) / kT;  // slots whose bins a thread keeps
  const int j = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n_groups = (a.M + kSlots - 1) / kSlots;  // a tile's blocks are adjacent
  const int t = blockIdx.x / n_groups, m0 = blockIdx.x % n_groups * kSlots;
  const int SB = a.S * a.book;
  const float f = (a.ip || a.rabitq) ? -1.f : -2.f;
  const size_t F = static_cast<size_t>(a.cap) * kLanes;

  int cc_lo;
  const int cc_hi = tile_slices(a, t, &cc_lo);
  if (cc_hi <= cc_lo) {  // uniform in the block: no row, every entry empty
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int g = j + kT * u;
      if (g >= kSlots || m0 + g >= a.M) continue;
      const size_t o = (static_cast<size_t>(t) * a.M + m0 + g) * F;
      for (int r = 0; r < a.cap; ++r) {
        a.out_v[o + r * kLanes + lane] = f * -INFINITY;
        a.out_i[o + r * kLanes + lane] = 0;
      }
    }
    return;
  }
  float* qs = reinterpret_cast<float*>(smem);
  T* lut = reinterpret_cast<T*>(smem + align16(static_cast<size_t>(kSlots) * a.dp * sizeof(float)));
  uint32_t* ring = reinterpret_cast<uint32_t*>(
      reinterpret_cast<unsigned char*>(lut) +
      align16(static_cast<size_t>(SB + 1) * kSlots * sizeof(T)));
  Acc* part = reinterpret_cast<Acc*>(ring + 2 * a.nw * kLanes);  // [2][kT][kSlots][128]

  const int base = a.al[t];
  const int l = a.lo[t], h = l + a.sizes[t];
  const int stage_words = a.nw * kLanes;
  // code words of slice cc_lo + i into ring slot `slot`, 4 rows per copy
  auto stage = [&](int i, int slot) {
    uint32_t* dst = ring + slot * stage_words;
    const int row0 = base + (cc_lo + i) * kLanes;
    for (int u = threadIdx.x; u < stage_words / 4; u += blockDim.x) {
      const int w = u / (kLanes / 4), r = (u % (kLanes / 4)) * 4, row = row0 + r;
      const uint32_t* src = a.codes + static_cast<size_t>(w) * a.n_pad;
      uint32_t* d = dst + w * kLanes + r;
      // rows past n_pad read as zeros (from a valid address, no bytes)
      if (a.vec) {
        const int n = max(0, min(4, a.n_pad - row));
        cp_async16(smem_addr(d), n > 0 ? src + row : a.codes, 4 * n);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const bool in = row + b < a.n_pad;
          cp_async4(smem_addr(d + b), in ? src + row + b : a.codes, in ? 4 : 0);
        }
      }
    }
  };
  stage(0, 0);  // in flight while the table is built
  cp_async_commit();
  const int live = min(kSlots, a.M - m0);
  load_qrows(a, t, m0, kSlots, qs);
  __syncthreads();
  const float ls = a.int8_mode ? __fdiv_rn(fmaxf(a.absmax[t], 1e-30f), 127.f) : 1.f;
  const float inv_ls = 1.f / ls;
  auto store = [&](int e, const float (&acc)[kSlots]) {
#pragma unroll
    for (int g = 0; g < kSlots; ++g) {
      if constexpr (std::is_same<T, int8_t>::value)  // |lut/ls| <= 127: no clip needed
        lut[e * kSlots + g] = quantize(acc[g], ls, inv_ls);
      else
        lut[e * kSlots + g] = __float2bfloat16_rn(acc[g]);
    }
  };
  // entry SB, zero, is what an out-of-book code selects
  if (a.book % 4 == 0) {
    lut_quads<kSlots>(a, qs, live, [&](int e0, const float (&acc)[4][kSlots]) {
      store_quad<T, kSlots>(lut, e0, acc, ls, inv_ls);
    });
    if (threadIdx.x == 0) store(SB, {});
  } else {
    lut_entries<kSlots>(a, qs, live, SB + 1, store);
  }

  Bins<kDepth> bins[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) bins[u].clear();
  const uint32_t mask = a.bits >= 32 ? 0xffffffffu : ((1u << a.bits) - 1);
  // slice i's epilogue: the kT partial sums of each owned slot, added in
  // order j = 0..kT-1, then the chain
  auto epilogue = [&](int i) {
    const int cc = cc_lo + i, pos = cc * kLanes + lane;
    if (pos < l || pos >= h) return;  // outside the list: -inf, never inserted
    const int row = base + pos;
    const float nrm = row < a.n_norms ? a.norms[row] : 0.f;
    const float frv = a.rabitq && row < a.n_norms ? a.fr[row] : 0.f;
    const Acc* pp = part + (i & 1) * (kT * kSlots * kLanes) + lane;
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int g = j + kT * u;
      if (g >= kSlots) continue;
      Acc s = pp[g * kLanes];
#pragma unroll
      for (int jj = 1; jj < kT; ++jj) {
        if constexpr (std::is_same<T, int8_t>::value)
          s += pp[(jj * kSlots + g) * kLanes];
        else
          s = __fadd_rn(s, pp[(jj * kSlots + g) * kLanes]);
      }
      const float dots =
          a.int8_mode ? __fmul_rn(static_cast<float>(s), ls) : static_cast<float>(s);
      float v;
      if (a.rabitq) {
        v = -__fadd_rn(nrm, __fmul_rn(frv, dots));
      } else {
        const float pen = a.ip ? (a.use_pen ? nrm : 0.f) : __fmul_rn(nrm, 0.5f);
        v = __fsub_rn(dots, pen);
      }
      bins[u].insert(v, static_cast<uint32_t>(cc));
    }
  };
  auto score = [&](int i, int slot) {
    if (i > 0) epilogue(i - 1);  // its partials were published by the barrier
    const int pos = (cc_lo + i) * kLanes + lane;
    if (pos < l || pos >= h) return;
    const uint32_t* sw = ring + slot * stage_words + lane;
    Acc acc[kSlots];
#pragma unroll
    for (int g = 0; g < kSlots; ++g) acc[g] = Acc(0);
    auto lookup = [&](int s, uint32_t code) {
      if constexpr (kBits > 0)  // book == 2^kBits: every code is in the book
        add_entry<kSlots>(lut, (s << kBits) | static_cast<int>(code), acc);
      else
        add_entry<kSlots>(lut,
                          code < static_cast<uint32_t>(a.book)
                              ? s * a.book + static_cast<int>(code)
                              : SB,
                          acc);
    };
    if constexpr (kBits > 0) {
      // periods of kP codes in kWp whole words, periods j, j + kT, ...:
      // constant shifts, a funnel shift where a code straddles two words
      constexpr int kWp = kBits / gcd_c(32, kBits), kP = 32 / gcd_c(32, kBits);
      constexpr uint32_t kMask = kBits >= 32 ? 0xffffffffu : (1u << kBits) - 1;
#pragma unroll 4
      for (int p = j; p * kP < a.S; p += kT) {
        uint32_t wd[kWp];
#pragma unroll
        for (int i2 = 0; i2 < kWp; ++i2)
          wd[i2] = p * kWp + i2 < a.nw ? sw[(p * kWp + i2) * kLanes] : 0u;
#pragma unroll
        for (int c = 0; c < kP; ++c) {
          const int bit = c * kBits, w = bit / 32, o = bit % 32;
          const uint32_t code =
              (o + kBits <= 32 ? wd[w] >> o
                               : __funnelshift_r(wd[w], wd[w + 1 < kWp ? w + 1 : w], o)) &
              kMask;
          if (p * kP + c < a.S) lookup(p * kP + c, code);
        }
      }
    } else {
      // the same periods, each through a 64-bit bit buffer from its first
      // word: a code that straddles two words takes its high bits from the
      // next one
      for (int p = j; p * a.period < a.S; p += kT) {
        int wi = p * a.period_words;
        uint64_t buf = sw[wi * kLanes];
        int have = 32;
        ++wi;
        const int s_end = min(a.S, (p + 1) * a.period);
        for (int s = p * a.period; s < s_end; ++s) {
          if (have < a.bits) {
            buf |= static_cast<uint64_t>(sw[wi * kLanes]) << have;
            have += 32;
            ++wi;
          }
          lookup(s, static_cast<uint32_t>(buf) & mask);
          buf >>= a.bits;
          have -= a.bits;
        }
      }
    }
    Acc* pp = part + (i & 1) * (kT * kSlots * kLanes) + j * kSlots * kLanes + lane;
#pragma unroll
    for (int g = 0; g < kSlots; ++g) pp[g * kLanes] = acc[g];
  };
  // two-stage ring: slice i + 1's words load while slice i is scored; the
  // barrier at the top also publishes the table and slice i - 1's partials
  const int n_sl = cc_hi - cc_lo;
  for (int i = 0; i < n_sl; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_sl) stage(i + 1, (i + 1) & 1);
    cp_async_commit();
    score(i, i & 1);
  }
  __syncthreads();
  epilogue(n_sl - 1);

  // the first cap levels: the cap-deep chain's bins (prefix-stable)
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int g = j + kT * u;
    if (g >= kSlots || m0 + g >= a.M) continue;
    const size_t o = (static_cast<size_t>(t) * a.M + m0 + g) * F;
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      if (r >= a.cap) break;
      a.out_v[o + r * kLanes + lane] = f * bins[u].v[r];
      a.out_i[o + r * kLanes + lane] = static_cast<uint8_t>(bins[u].slice(r));
    }
  }
}

template <typename Kern, typename... More>
cudaError_t launch(Kern kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t st, const Args& a,
                   More... more) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, block, smem, st>>>(a, more...);
  return cudaGetLastError();
}

// A scan block of `slots` slots over every tile: n_tiles * ceil(M / slots)
// blocks of kT * 128 threads.
template <typename Kern>
cudaError_t launch_scan_kernel(Kern kernel, int slots, int n_tiles, cudaStream_t st,
                               const Args& a) {
  return launch(kernel, dim3(n_tiles * ((a.M + slots - 1) / slots)), dim3(kT * kLanes),
                scan_smem(slots, a), st, a);
}

// pq_scan_deep.cu: the scan at cap 3..kMaxCap. slots = 0: no block fits.
struct DeepPlan {
  int slots = 0;
  int kind = 0;  // the family of instantiations (pq_scan_deep.cu)
};
DeepPlan plan_deep(const Args& a);
cudaError_t launch_deep(const DeepPlan& p, int n_tiles, cudaStream_t st, const Args& a);

}  // namespace pq
}  // namespace cuvs_tpu_torch
