// Tensor-core slice mainloop for the brute-force kernels (bf_topk.cu) and
// the IVF-Flat scan (ivf_scan.cu) on Hopper (sm_90a): bf16 x bf16 -> f32 with
// mma.sync m16n8k16, and int8 x int8 -> int32 with mma.sync m16n8k32 (exact
// in any order).
//
// Replaces the shared-memory FMA / __dp4a mainloop of the first port under
// cuvs_tpu/ops/bf_topk_pallas.py::_approx_kernel, for bf16 and int8 rows under
// _fused_kernel, and under ivf_scan_pallas.py::_scan_kernel. What bounds that
// work on this card is the products (2 * B * N * d operations: 989 TFLOP/s
// bf16, 1979 TOP/s int8) and, once they run on tensor cores, the bytes of the
// dataset that each block pulls through L2. The design:
//
//  * A block owns kBQ = 16 * kMI * kWM query rows and walks the 128-row
//    slices of one dataset tile; 4 * kWM warps, each a (16 * kMI)-query x
//    32-column warp tile (kMI x 4 MMA tiles; the brute force's kMI = 2), so
//    the running state of the epilogue stays in the same registers as the
//    accumulators for the whole tile. A caller may multiply only some of
//    each warp's four 8-column MMA tiles (compute's kN, ni0): the IVF-Flat
//    scan's deep bins keep fewer columns a block.
//  * The block's queries stay resident in shared memory (kBQ x d, zero-padded
//    to 128-byte chunks, so any d works); the dataset streams through a ring
//    of [128 rows x 128 bytes] chunks by cp.async, in its own type (no
//    widening), with an XOR swizzle of the 16-byte units so that ldmatrix
//    reads are free of bank conflicts. Chunks go two to a barrier, three
//    groups in flight. The launcher takes the widest block (kWM = 4, 2, 1)
//    whose shared memory fits: approximate search takes bf16 rows up to
//    d = 2560 and int8 up to 5120, exact search somewhat less (its lists).
//  * The caller orders the grid so that the query blocks of one tile run
//    together: the tile is read from device memory about once per batch and
//    served to the other blocks from the 50 MB L2, as the TPU kernel's
//    dataset-stationary grid did.
//
// It also holds the pieces the fp32 mainloop (fma_tile.cuh) shares: cp.async
// staging with zero fill and the chunk pipeline.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cuvs_tpu_torch {

constexpr int kSliceRows = 128;  // dataset rows (columns of the score block) per slice
constexpr int kChunkBytes = 128; // bytes of each row per staged chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy of src_bytes (the rest of the 16 zero-filled).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
// 4-byte asynchronous copy of src_bytes (0 or 4; 0 writes a zero word).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage 16-byte unit u of row r of a [rows x 128 B] tile: elements
// [e, e + 16 / sizeof(T)) of the row at p (nullptr: a row of zeros), zero past
// d. vec: rows are 16-byte aligned and d * sizeof(T) is a multiple of 16, so
// a unit is all in (cp.async) or all out (zeros); otherwise element by element
// through registers (ragged d). Plain stores are visible after the next
// barrier, as the pipeline's waits make the copies.
template <typename T>
__device__ __forceinline__ void stage_unit(char* dst, const T* p, int e, int d, bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
    if (p != nullptr && e < d)
      cp_async16(smem_addr(dst), p + e, 16);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    return;
  }
  using Raw = typename std::conditional<sizeof(T) == 4, uint32_t,
              typename std::conditional<sizeof(T) == 2, uint16_t, uint8_t>::type>::type;
  const Raw* src = reinterpret_cast<const Raw*>(p);
  Raw* out = reinterpret_cast<Raw*>(dst);
#pragma unroll
  for (int b = 0; b < kPer; ++b) out[b] = (p != nullptr && e + b < d) ? src[e + b] : Raw(0);
}

// The chunk pipeline over a ring of kStages * kGroup chunk slots:
// stage(j, slot) issues the copies of chunk j into ring slot `slot`;
// compute(i, slot) consumes chunk i. Chunks go in groups of kGroup, one
// barrier per group, with kStages - 1 groups in flight while one is computed.
template <int kStages, int kGroup, typename Stage, typename Compute>
__device__ __forceinline__ void run_chunks(int n_chunks, Stage stage, Compute compute) {
  const int n_groups = (n_chunks + kGroup - 1) / kGroup;
  auto stage_group = [&](int jg) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (jg * kGroup + g < n_chunks) stage(jg * kGroup + g, (jg % kStages) * kGroup + g);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_groups) stage_group(st);
    cp_async_commit();
  }
  for (int ig = 0; ig < n_groups; ++ig) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ig + kStages - 1 < n_groups) stage_group(ig + kStages - 1);
    cp_async_commit();
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (ig * kGroup + g < n_chunks) compute(ig * kGroup + g, (ig % kStages) * kGroup + g);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// D += A * B on one 16 x 8 tile over 32 bytes of k (16 bf16 or 32 int8).
__device__ __forceinline__ void mma_k32b(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k32b(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte unit u of row r in a [rows x 128 B] swizzled tile.
__device__ __forceinline__ int swz(int r, int u) { return r * kChunkBytes + ((u ^ (r & 7)) << 4); }

template <typename T, int kWM, int kMI = 2>
struct MmaTile {
  static_assert(std::is_same<T, __nv_bfloat16>::value || std::is_same<T, int8_t>::value,
                "tensor-core tile takes bf16 or int8 rows");
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  static constexpr int kBQ = 16 * kMI * kWM;
  static constexpr int kWarps = 4 * kWM;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = 4;  // groups of kGroup chunks
  // the narrowest block keeps its ring small for the widest rows
  static constexpr int kGroup = kWM > 1 ? 2 : 1;
  static constexpr int kChunkElems = kChunkBytes / sizeof(T);
  static constexpr int kTileBytes = kSliceRows * kChunkBytes;

  static __host__ __device__ int n_chunks_k(int d) { return (d + kChunkElems - 1) / kChunkElems; }
  // resident queries + the dataset ring
  static __host__ __device__ size_t smem_bytes(int d) {
    return static_cast<size_t>(kBQ) * n_chunks_k(d) * kChunkBytes +
           static_cast<size_t>(kStages) * kGroup * kTileBytes;
  }

  // Accumulator element e of MMA tile (mi, ni) of this thread: its query row
  // and column within the block's [kBQ x 128] slice.
  static __device__ __forceinline__ int row_of(int mi, int e) {
    return (threadIdx.x / 32 / 4) * 16 * kMI + mi * 16 + (threadIdx.x % 32) / 4 + 8 * (e >> 1);
  }
  static __device__ __forceinline__ int col_of(int ni, int e) {
    return (threadIdx.x / 32 % 4) * 32 + ni * 8 + 2 * (threadIdx.x % 4) + (e & 1);
  }

  // Copy the block's query rows into qs as n_chunks_k(d) chunk-major
  // [kBQ x 128 B] tiles: row_ptr(r) gives row r, or nullptr for zeros.
  template <typename RowPtr>
  static __device__ void stage_query_rows(char* qs, RowPtr row_ptr, int d, bool vec) {
    const int nk = n_chunks_k(d);
    for (int i = threadIdx.x; i < nk * kBQ * 8; i += kThreads) {
      const int u = i & 7, r = (i >> 3) % kBQ, kc = (i >> 3) / kBQ;
      stage_unit(qs + static_cast<size_t>(kc) * kBQ * kChunkBytes + swz(r, u), row_ptr(r),
                 kc * kChunkElems + u * (16 / static_cast<int>(sizeof(T))), d, vec);
    }
  }
  // Query rows [qb, qb + kBQ) of q (rows past B are zeros).
  static __device__ void stage_queries(char* qs, const T* q, int qb, int B, int d, bool vec) {
    stage_query_rows(qs, [&](int r) -> const T* {
      return qb + r < B ? q + static_cast<size_t>(qb + r) * d : nullptr;
    }, d, vec);
  }

  // Thread t stages 16-byte unit t % 8 of dataset rows t / 8 + (kThreads / 8) m.
  static constexpr int kRowsPerThread = kSliceRows * 8 / kThreads;

  // The thread's staging rows of one slice: row_ptr(r) gives row r or
  // nullptr for a row of zeros.
  template <typename RowPtr>
  static __device__ __forceinline__ void rows(const T* (&p)[kRowsPerThread], RowPtr row_ptr) {
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) p[m] = row_ptr(threadIdx.x / 8 + kThreads / 8 * m);
  }

  // Copy chunk kc of those rows into ring slot `tile`.
  static __device__ __forceinline__ void stage_rows(char* tile, const T* const (&p)[kRowsPerThread],
                                                    int kc, int d, bool vec) {
    const int u = threadIdx.x % 8;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m)
      stage_unit(tile + swz(threadIdx.x / 8 + kThreads / 8 * m, u), p[m],
                 kc * kChunkElems + u * (16 / static_cast<int>(sizeof(T))), d, vec);
  }

  // acc[mi][n] += this warp's products over one 128-byte chunk, for its MMA
  // tiles of columns ni0 + n (kN = 4, ni0 = 0: all 32 columns; kN = 2: ni0
  // even). Each element's sum is the same at any kN.
  template <int kN>
  static __device__ __forceinline__ void compute(const char* qtile, const char* xtile,
                                                 Acc (&acc)[kMI][kN][4], int ni0 = 0) {
    static_assert(kN == 1 || kN == 2 || kN == 4, "MMA tiles per warp");
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4;
    const uint32_t qa = smem_addr(qtile), xa = smem_addr(xtile);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[kMI][4], b[kN][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int r = wm * 16 * kMI + mi * 16 + (lane & 15);
        ldmatrix_x4(qa + swz(r, ks * 2 + (lane >> 4)), a[mi][0], a[mi][1], a[mi][2], a[mi][3]);
      }
      if constexpr (kN == 1) {
        const int r = wn * 32 + ni0 * 8 + (lane & 7);
        ldmatrix_x2(xa + swz(r, ks * 2 + ((lane >> 3) & 1)), b[0][0], b[0][1]);
      } else {
#pragma unroll
        for (int nj = 0; nj < kN / 2; ++nj) {
          const int m = lane >> 3;
          const int r = wn * 32 + ni0 * 8 + nj * 16 + (m >> 1) * 8 + (lane & 7);
          ldmatrix_x4(xa + swz(r, ks * 2 + (m & 1)), b[2 * nj][0], b[2 * nj][1],
                      b[2 * nj + 1][0], b[2 * nj + 1][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int n = 0; n < kN; ++n) mma_k32b(acc[mi][n], a[mi], b[n][0], b[n][1]);
    }
  }
};

}  // namespace cuvs_tpu_torch
