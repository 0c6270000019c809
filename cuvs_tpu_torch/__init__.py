"""cuvs_tpu_torch — the search path of cuvs_tpu on PyTorch and CUDA.

The module layout and public signatures mirror ``cuvs_tpu``; tensors replace
JAX arrays, and the TPU's Pallas kernels are hand-written CUDA kernels
(``csrc/``) built with nvcc at their first launch on a CUDA tensor. Importing
the package imports neither JAX nor Triton and builds nothing.
"""

from cuvs_tpu_torch import interop  # noqa: F401
from cuvs_tpu_torch.cluster import kmeans_balanced  # noqa: F401
from cuvs_tpu_torch.distance import fused_l2_nn, pairwise  # noqa: F401
from cuvs_tpu_torch.neighbors import brute_force, filters, ivf_flat, ivf_scan, refine  # noqa: F401
from cuvs_tpu_torch.ops import bf_topk, ivf_scan as ops_ivf_scan  # noqa: F401
from cuvs_tpu_torch.selection import select_k  # noqa: F401

__version__ = "0.1.0"
