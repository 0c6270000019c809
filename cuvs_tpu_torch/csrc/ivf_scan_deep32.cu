// Fused IVF-Flat scan, deep bins at depth classes 16 and 32 (cap 9-32:
// k = 257-1024 over windows of more than 8 slices): ivf_scan_deep.cu's
// design, in a source of its own so that nvcc builds it in parallel.
#include "ivf_scan.cuh"

namespace cuvs_tpu_torch {

cudaError_t launch_deep32(int dtype, int qdtype, int depth, const ScanArgs& s,
                          cudaStream_t st) {
  return depth == 16 ? launch_deep_class<16>(dtype, qdtype, s, st)
                     : launch_deep_class<32>(dtype, qdtype, s, st);
}

}  // namespace cuvs_tpu_torch
