// Fused IVF-Flat scan, deep bins: ivf_scan_mma_kernel (bf16 and int8 rows)
// and ivf_scan_fma_kernel (f32 rows, and bf16 rows with f32 queries) of
// ivf_scan.cuh at cap 3-32, which every IVF-Flat search with k > 64 runs
// (cap = ceil(k / 32): k = 100 gives 4). Both replace
// cuvs_tpu/ops/ivf_scan_pallas.py::_scan_kernel there. This source holds
// depth classes 4 and 8 (k = 65-256), ivf_scan_deep32.cu 16 and 32: two
// sources, so that nvcc builds them in parallel processes.
//
// What held the first version back: one runtime depth (cap <= 32) for every
// cap, so each thread's 32 elements kept 32-deep bins in 8 KB of local
// memory, indexed at run time; with 256 threads a block, 2 MB a block, far
// past L1, so every chain step of every score went to L2 (f32 rows at
// k = 100: slower than the plain version).
//
// The design: the cap-2 kernels' mainloops and epilogue, with the bins in
// registers at a compile-time depth class kD >= min(cap, W / 128), fully
// unrolled (ivf_scan.cuh). A thread keeps 64 levels (80 registers) of bins
// (launch_deep_class):
//  * Tensor-core rows: 8 warps of 16 slots x 32 columns (kMI = 1, 32 slots a
//    block), 16 elements a thread; from kD = 8 a block multiplies and keeps
//    one of kD / 4 column parts of each slice. (The cap-2 block's 64 slots
//    keeping half the columns ran 3% slower at k = 100 on the NVIDIA H100:
//    1.96 ms against 1.90.)
//  * fp32 rows: the cap-2 block, FmaTile<4> (64 slots), keeping one of
//    kD / 2 column parts (kD = 4: 4 x 4 elements a thread); at kD = 32
//    FmaTile<2> (32 slots) with 8 parts (2 x 1). The taller micro-tile keeps
//    the FMA units fed: on the NVIDIA H100, f32 rows at k = 100 took
//    8.33 ms against 9.59 with FmaTile<2> keeping every column. Query rows
//    stay resident where they fit, as at cap 2.
//  * A part's products are its columns' alone (each element's sum is
//    unchanged); a slot block's parts are adjacent blocks that each stage
//    the whole slice, so the window is read through L2 once a part.
//  * Blocks none of whose slots holds a query skip the window's rows.
//  * The products, their order and the chain are the cap-2 kernels', so the
//    pools are bit-identical to the runtime-depth version's.
#include "ivf_scan.cuh"

namespace cuvs_tpu_torch {

cudaError_t launch_deep(int dtype, int qdtype, const ScanArgs& s, cudaStream_t st) {
  const int depth = depth_class(s.cap, s.W);
  if (depth > 8) return launch_deep32(dtype, qdtype, depth, s, st);
  return depth == 4 ? launch_deep_class<4>(dtype, qdtype, s, st)
                    : launch_deep_class<8>(dtype, qdtype, s, st);
}

}  // namespace cuvs_tpu_torch
