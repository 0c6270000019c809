"""cuvs_tpu_torch — cuvs_tpu's search, IVF and CAGRA indexes on PyTorch and CUDA.

The module layout and public signatures mirror ``cuvs_tpu``; tensors replace
JAX arrays, and the TPU's Pallas kernels are hand-written CUDA kernels
(``csrc/``) built with nvcc at their first launch on a CUDA tensor.
Subpackages: ``neighbors`` (every index family and the serving composition:
tiered, offloaded and dynamically batched indexes), ``cluster`` (k-means and
balanced k-means), ``mg`` (sharded and replicated indexes and k-means over a
list of devices), ``io`` (big-ann dataset files over a host library that
``c++`` builds from ``native/`` at its first use), ``distance``,
``selection``, ``preprocessing``, ``core``, ``utils`` and ``bench``.
Importing the package imports neither JAX nor Triton and builds nothing.
"""

from cuvs_tpu_torch import interop, io, mg  # noqa: F401
from cuvs_tpu_torch.cluster import kmeans, kmeans_balanced  # noqa: F401
from cuvs_tpu_torch.distance import fused_l2_nn, pairwise  # noqa: F401
from cuvs_tpu_torch.neighbors import (  # noqa: F401
    all_neighbors, brute_force, cagra, dynamic_batching, filters, graph_core, ivf_flat, ivf_pq,
    ivf_rabitq, ivf_scan, ivf_sq, knn_graph, nn_descent, offload, refine, tiered_index)
from cuvs_tpu_torch.ops import bf_topk, ivf_scan as ops_ivf_scan  # noqa: F401
from cuvs_tpu_torch.preprocessing import quantize  # noqa: F401
from cuvs_tpu_torch.selection import select_k  # noqa: F401
from cuvs_tpu_torch.utils import serialize  # noqa: F401

__version__ = "0.1.0"
