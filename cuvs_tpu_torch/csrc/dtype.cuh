// Element-type codes of the kernels' C entry points (ops/_lib.py DTYPE_CODE).
#pragma once

namespace cuvs_tpu_torch {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

}  // namespace cuvs_tpu_torch
