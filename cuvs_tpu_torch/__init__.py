"""cuvs_tpu_torch — cuvs_tpu's search, IVF and CAGRA indexes on PyTorch and CUDA.

The module layout and public signatures mirror ``cuvs_tpu``; tensors replace
JAX arrays, and the TPU's Pallas kernels are hand-written CUDA kernels
(``csrc/``) built with nvcc at their first launch on a CUDA tensor.
Subpackages: ``neighbors`` (every index family, the serving composition:
tiered, offloaded and dynamically batched indexes, and the long tail: ball
cover, epsilon neighbourhoods, cross-component edges, sparse brute force),
``cluster`` (k-means, balanced k-means, single-linkage and spectral
clustering), ``mg`` (sharded and replicated indexes and k-means over a list
of devices), ``io`` (big-ann dataset files over a host library that ``c++``
builds from ``native/`` at its first use), ``distance`` (pairwise
distances, Gram matrices, KDE), ``selection``, ``preprocessing`` (quantizers,
PCA, spectral embedding), ``stats``, ``core``, ``utils`` and ``bench``;
``capi`` builds the C ABI of ``capi/`` over the port (``capi_bridge``).
Importing the package imports neither JAX nor Triton and builds nothing.
"""

from cuvs_tpu_torch import interop, io, mg, stats  # noqa: F401
from cuvs_tpu_torch.cluster import (agglomerative, kmeans, kmeans_balanced,  # noqa: F401
                                    spectral)
from cuvs_tpu_torch.distance import fused_l2_nn, kernels, pairwise  # noqa: F401
from cuvs_tpu_torch.neighbors import (  # noqa: F401
    all_neighbors, ball_cover, brute_force, cagra, cross_component, dynamic_batching,
    epsilon_neighborhood, filters, graph_core, ivf_flat, ivf_pq, ivf_rabitq, ivf_scan, ivf_sq,
    knn_graph, nn_descent, offload, refine, sparse_brute_force, tiered_index)
from cuvs_tpu_torch.ops import bf_topk, ivf_scan as ops_ivf_scan  # noqa: F401
from cuvs_tpu_torch.preprocessing import pca, quantize  # noqa: F401
from cuvs_tpu_torch.selection import select_k  # noqa: F401
from cuvs_tpu_torch.utils import serialize  # noqa: F401

__version__ = "0.1.0"
