// Fused quantized-code IVF scan at the code widths that pq_scan.cu and
// pq_scan_deep.cu leave to the bit buffer: pq_scan_kernel (pq_scan.cuh) for
// IVF-PQ's byte codes with a book of 16, 32, 64 or 128 entries (pq_bits 4-7:
// the fused layout keeps every PQ code in a byte), with a bf16 or an int8
// table, and for IVF-RaBitQ at 1, 2 and 4-8 bits a dimension (3 bits keeps
// its table), at cap <= 2 and depth class 4 (cap 3-4, k <= 128). Replaces
// cuvs_tpu/ops/ivf_scan_pallas.py::_pq_scan_kernel at those shapes.
//
// IVF-PQ. Every book but 256 decoded through the 64-bit bit buffer: per code
// a refill test, a shift, a mask and a book test with a select, in a loop
// that does not unroll. Here the decode is PQ 8-bit's (four codes a word,
// constant shifts) and the book is a compile-time power of two, so a code
// indexes its subspace's entries by a shift and an or. A code past the book
// selects the zero entry, as in the plain version; one test of the word's
// high bits finds one, and only then does the period take the per-code
// test. The smaller tables let 8 slots share a block's decode: a bf16 table
// of pq_dim 64 is 2 KB a slot at 4 bits, 16 KB at 7; two blocks an SM but
// for the bf16 table at 7 bits.
//
// IVF-RaBitQ. Every width but 3 decoded through the bit buffer, and a slot's
// table held S*book entries, 64 KB of bf16 at 8 bits and 128 dimensions, so
// 2 slots filled a block, one block an SM, and each slot built its 32,768
// entries from the codebook in L2 before its first lookup. The decode is now
// compile-time at every width: 32 codes a word at 1 bit, 16 at 2, 8 at 4, 32
// in 5 words at 5, 16 in 3 at 6, 32 in 7 at 7, 4 a word at 8. At 1, 2 and 4
// bits a slot's table is small (S*2^bits entries, 8 KB of 8 slots at 2 bits)
// and is built as at 3 bits. From 5 bits the entries are formed in
// registers: a RaBitQ index passes pq_len 1, so entry (s, c) of a slot is one
// product, q_s * cb[s, s*book + c]; a block stages the decode matrix's S*book
// diagonal values once for its 8 slots (64 KB at 8 bits, 8 KB at 5) and
// their query values, and each lookup forms the 8 slots' entries from one
// diagonal value with four mul.rn.bf16x2: the table's values, bit for bit
// (reg_entry). Each lookup costs more there than a table read (a product and
// a widening per slot), which the small tables win (13-18% at 1-4 bits, NVIDIA
// H100, bench/scan_compare.py); from 5 bits the table's build and its share
// of shared memory cost more. Two blocks an SM to 7 bits; at 8 the diagonal
// and a slice's 32 code words leave room for one.
#include "pq_scan.cuh"

namespace cuvs_tpu_torch {
namespace pq {

namespace {

constexpr int kWidthSlots = 8;  // slots a block, every width here (no spill at 64 registers)
// RaBitQ's widths from this one up form their entries in registers; the
// narrower ones build a table of S * 2^bits entries a slot
constexpr int kRegMinBits = 5;

// The compile-time width kBits (book 2^kLog) at depth class 2 or 4, table
// entries or register entries (kReg), kMinBlocks blocks an SM by registers.
template <typename T, int kBits, int kLog, bool kReg, int kMinBlocks>
cudaError_t launch_depths(int n_tiles, cudaStream_t st, const Args& a) {
  constexpr Kind kind = kReg ? kWidthReg : kWidthTable;
  if (a.cap <= 2)
    return launch_scan_kernel(pq_scan_kernel<T, kWidthSlots, 2, kBits, kMinBlocks, kLog, kReg>,
                              kWidthSlots, n_tiles, st, a, 2, kind, kReg);
  return launch_scan_kernel(pq_scan_kernel<T, kWidthSlots, 4, kBits, kMinBlocks, kLog, kReg>,
                            kWidthSlots, n_tiles, st, a, 4, kind, kReg);
}

// IVF-PQ's byte codes, book 2^kLog: a table with either entry type
template <int kLog>
cudaError_t launch_book(int n_tiles, cudaStream_t st, const Args& a) {
  return a.int8_mode ? launch_depths<int8_t, 8, kLog, false, 2>(n_tiles, st, a)
                     : launch_depths<__nv_bfloat16, 8, kLog, false, 2>(n_tiles, st, a);
}

// RaBitQ at kBits a code, full book, bf16 (at 8 bits the diagonal and a
// slice's 32 code words leave room for one block an SM)
template <int kBits>
cudaError_t launch_rabitq(int n_tiles, cudaStream_t st, const Args& a) {
  constexpr bool kReg = kBits >= kRegMinBits;
  return launch_depths<__nv_bfloat16, kBits, kBits, kReg, kBits == 8 ? 1 : 2>(n_tiles, st, a);
}

bool pq_book(const Args& a) { return a.bits == 8 && a.book_log2 >= 4 && a.book_log2 <= 7; }

}  // namespace

// The family a call at cap <= 4 runs here, if any (pq_scan.cuh): IVF-PQ's
// byte codes with a book of 16-128, RaBitQ at 1, 2 and 4-8 bits.
DeepPlan plan_width(const Args& a) {
  if (a.cap > 4) return {};
  const bool rabitq = a.rabitq && !a.int8_mode && a.pq_len == 1 && a.bits <= 8 && a.bits != 3 &&
                      a.book == 1 << a.bits;
  if (!pq_book(a) && !rabitq) return {};
  const bool reg = !pq_book(a) && a.bits >= kRegMinBits;
  if (scan_smem(kWidthSlots, a, reg) > smem_limit(false)) return {};
  return {kWidthSlots, reg ? kWidthReg : kWidthTable};
}

cudaError_t launch_width(const DeepPlan& p, int n_tiles, cudaStream_t st, const Args& a) {
  if (p.slots != kWidthSlots) return cudaErrorInvalidValue;
  if (pq_book(a)) {
    switch (a.book_log2) {
      case 4: return launch_book<4>(n_tiles, st, a);
      case 5: return launch_book<5>(n_tiles, st, a);
      case 6: return launch_book<6>(n_tiles, st, a);
      default: return launch_book<7>(n_tiles, st, a);
    }
  }
  switch (a.bits) {
    case 1: return launch_rabitq<1>(n_tiles, st, a);
    case 2: return launch_rabitq<2>(n_tiles, st, a);
    case 4: return launch_rabitq<4>(n_tiles, st, a);
    case 5: return launch_rabitq<5>(n_tiles, st, a);
    case 6: return launch_rabitq<6>(n_tiles, st, a);
    case 7: return launch_rabitq<7>(n_tiles, st, a);
    case 8: return launch_rabitq<8>(n_tiles, st, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pq
}  // namespace cuvs_tpu_torch
