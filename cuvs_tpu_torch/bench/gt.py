"""Exact ground truth with an unfused cross-check — port of ``cuvs_tpu.bench.gt``.

Every recall figure is measured against exact brute-force ground truth
(naive_knn.cuh:95). The fused exact kernel (per-tile top-k, IEEE f32
products) computes it for the whole batch; the unfused path recomputes
``ncheck`` queries and the two must agree: ids to >= 99.5% (ties may swap
ids) and the sorted distances to rtol 1e-3. Unlike the reference, which falls
back to the unfused path on disagreement or on an exception, a disagreement
raises here: a wrong kernel must not be hidden behind a slower path.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cuvs_tpu_torch.neighbors import brute_force


class GroundTruthMismatch(RuntimeError):
    """The fused exact kernel disagreed with the unfused exact path."""


def id_recall(found, gt) -> float:
    """Mean fraction of each gt row's ids found in the same row of ``found``."""
    found, gt = np.asarray(found), np.asarray(gt)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(found, gt)]))


def exact_ground_truth(bf_index: brute_force.Index, queries, k: int, ncheck: int = 256,
                       verbose: bool = True):
    """Exact top-k ids [nq, k] (numpy) for ``queries`` against ``bf_index``.

    Raises GroundTruthMismatch when the fused kernel and the unfused path
    disagree on the first ``ncheck`` queries; with ``verbose`` the
    disagreement is printed to stderr first, as the reference prints it."""
    gtd, gti = brute_force.search(bf_index, queries, k, fused=True, compute_dtype=torch.float32)
    nc = min(ncheck, queries.shape[0])
    refd, refi = brute_force.search(bf_index, queries[:nc], k)
    agree = id_recall(gti[:nc].cpu(), refi.cpu())
    dist_ok = torch.allclose(torch.sort(gtd[:nc], 1).values, torch.sort(refd, 1).values,
                             rtol=1e-3, atol=1e-4)
    if agree < 0.995 or not dist_ok:
        if verbose:
            print(f"# fused GT disagrees with unfused (ids {agree:.4f}, dist_ok={dist_ok})",
                  file=sys.stderr)
        raise GroundTruthMismatch(f"fused ground truth disagrees with the unfused path "
                                  f"(ids {agree:.4f}, distances close: {dist_ok})")
    return gti.cpu().numpy()
