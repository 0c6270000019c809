"""Spectral embedding (Laplacian eigenmaps) — port of ``cuvs_tpu.preprocessing.spectral``.

cuvs::preprocessing::spectral_embedding (spectral_embedding.hpp,
params{n_components} :28, create_connectivity_graph :203). The connectivity
graph is the knn graph, symmetrized. Up to ``dense_threshold`` rows the
normalized Laplacian is built dense and ``torch.linalg.eigh`` gives its
smallest eigenvectors exactly; above it, LOBPCG finds the largest
eigenvectors of the shifted operator 2I - L_norm with a gather /
``index_add_`` matvec, no [n, n] matrix.

The LOBPCG is a port of JAX's ``jax.experimental.sparse.linalg.
lobpcg_standard`` (the reference's solver): the same orthonormalization
(SVQB twice), projections, Rayleigh-Ritz step, Householder basis extension
and convergence test, in float32. The small [3k, 3k] factorizations run on
the host. The starting block is drawn apart from the work:
``spectral_embedding`` draws it from a ``torch.Generator(seed)`` on the host,
and ``_embed`` takes it as an argument.

One deliberate divergence: the stop. LOBPCG stops once every residual
|A v - theta v| is below tol * 10 * n * (|A v| + theta); the reference keeps
JAX's default tol, float32 eps, so its bound loosens with n (0.12 of
|A v| + theta at 100,000 rows). ``spectral_embedding``
passes tol = 1e-4 / (10 n), a bound of 1e-4 (|A v| + theta) at every n;
``_embed(..., tol=None)`` is the reference's stop.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cuvs_tpu_torch.neighbors import knn_graph as kg
from cuvs_tpu_torch.utils.device import as_tensor as _on_device

_F32_EPS = float(torch.finfo(torch.float32).eps)
_RESIDUAL = 1e-4  # LOBPCG's stop: every residual below 1e-4 (|A v| + theta)


def _sym_knn_edges(x: torch.Tensor, n_neighbors: int, metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """The knn graph's edges and their reverses (src, dst) int64."""
    n = x.shape[0]
    k = min(n_neighbors, n - 1)
    nbrs, _ = kg.build_knn_graph(x, k, metric=metric)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = nbrs.reshape(-1).long()
    return torch.cat([rows, cols]), torch.cat([cols, rows])


def _on_host(fn, *mats):
    """A small factorization on the host; results back on the first
    matrix's device."""
    dev = mats[0].device
    out = fn(*(m.cpu() for m in mats))
    return tuple(o.to(dev) for o in out)


def _eigh_descending(a):
    w, v = _on_host(torch.linalg.eigh, a)
    return w.flip(0), v.flip(1)


def _col_norms(a):
    return torch.linalg.norm(a, dim=0, keepdim=True)


def _svqb(x):
    """A truncated orthonormal basis of x's columns (SVQB); the columns
    of a numerically rank-deficient x come out zero."""
    norms = _col_norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
    tau = _F32_EPS * w[0]
    sqrted = torch.where(tau > 0, torch.clamp_min(w, tau), 1.0) ** -0.5
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.float()
    norms = _col_norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis, u):
    """The component of u orthogonal to the (orthonormal) basis, its
    surviving columns orthonormal; orthogonality wins over rank."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_col_norms(u) >= 0.99).float()


def _extend_basis(x, m: int):
    """m more orthonormal columns for the orthonormal x (block Householder
    reflectors: deterministic, never overlapping x)."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = _on_host(torch.linalg.svd, upper)
    y = torch.cat([upper + u @ vt, lower])
    other = torch.cat([torch.eye(m, device=x.device),
                       torch.zeros((n - k - m, m), device=x.device)])
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def _lobpcg_standard(matvec: Callable, x: torch.Tensor, m: int = 100,
                     tol: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The top-k eigenpairs of a symmetric operator (LOBPCG, JAX's
    ``lobpcg_standard``). x [n, k] is the starting block (k * 5 < n).
    Returns (eigenvalues [k] descending, eigenvectors [n, k], iterations);
    stops after m iterations or once every pair's residual is below
    tol * 10 * n * (|A v| + lambda)."""
    n, k = x.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"expected 0 < search dim * 5 < matrix dim (got {k * 5}, {n})")
    tol = _F32_EPS if tol is None else tol
    x = _orthonormalize(x.float())
    p = _extend_basis(x, k)
    ax = matvec(x)
    theta = (x * ax).sum(0, keepdim=True)
    r = ax - theta * x
    i = 0
    while i < m:
        r = _project_out(torch.cat([x, p], 1), r)
        xpr = torch.cat([x, p, r], 1)
        theta, q = _eigh_descending(xpr.T @ matvec(xpr))
        b = q[:, :k]
        b = b / _col_norms(b)
        x = xpr @ b
        x = x / _col_norms(x)
        qq, _ = _on_host(torch.linalg.qr, q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        normp = _col_norms(p)
        p = p / torch.where(normp == 0, 1.0, normp)
        ax = matvec(x)
        r = ax - theta[None, :k] * x
        reltol = (torch.linalg.norm(ax, dim=0) + theta[:k]) * n * 10
        converged = int((torch.linalg.norm(r, dim=0) < tol * reltol).sum())
        theta = theta[None, :k]
        i += 1
        if converged >= k:
            break
    return theta[0], x, i


def _embed(x: torch.Tensor, n_components: int, n_neighbors: int, metric, n_iters: int,
           dense_threshold: int, guess: Optional[torch.Tensor],
           tol: Optional[float] = None) -> torch.Tensor:
    """The embedding of x's rows, LOBPCG (above ``dense_threshold`` rows)
    starting from ``guess`` [n, n_components + 1] and stopping at ``tol``
    (``_lobpcg_standard``'s; None: the reference's)."""
    n = x.shape[0]
    src, dst = _sym_knn_edges(x, n_neighbors, metric)
    if n <= dense_threshold:
        adj = torch.zeros((n, n), device=x.device)
        adj[src, dst] = 1.0  # a binary adjacency: multi-edges once
        adj = torch.maximum(adj, adj.T)
        deg = adj.sum(1)
        dinv = 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12))
        lap = torch.eye(n, device=x.device) - dinv[:, None] * adj * dinv[None, :]
        _, evecs = torch.linalg.eigh(lap)  # ascending: smallest first
        emb = evecs[:, 1:n_components + 1] * dinv[:, None]
    else:
        ones = torch.ones(src.shape, device=x.device)
        deg = torch.zeros((n,), device=x.device).index_add_(0, src, ones)
        dinv = 1.0 / torch.sqrt(torch.clamp_min(deg, 1.0))

        def matvec(v):  # (2I - L_norm) v
            agg = torch.zeros_like(v).index_add_(0, src, (v * dinv[:, None])[dst])
            return v + dinv[:, None] * agg

        theta, u, _ = _lobpcg_standard(matvec, guess.to(x.device).float(), m=n_iters, tol=tol)
        u = u[:, torch.argsort(-theta, stable=True)]
        emb = u[:, 1:n_components + 1] * dinv[:, None]
    return emb / torch.clamp_min(torch.linalg.norm(emb, dim=0, keepdim=True), 1e-12)


def spectral_embedding(x, n_components: int = 2, n_neighbors: int = 15, metric="euclidean",
                       n_iters: int = 300, seed: int = 0, dense_threshold: int = 4096,
                       device=None) -> torch.Tensor:
    """Rows -> [n, n_components] Laplacian eigenmap coordinates.

    n <= dense_threshold: a dense eigh of the normalized Laplacian (exact);
    larger n: at most ``n_iters`` LOBPCG iterations with a sparse matvec,
    started from a normal draw of ``torch.Generator(seed)`` on the host and
    stopped once every residual is below 1e-4 (|A v| + theta). Host data
    goes to ``device`` (None: the CUDA card)."""
    x = _on_device(x, device).float()
    n = x.shape[0]
    guess = None
    if n > dense_threshold:
        gen = torch.Generator()
        gen.manual_seed(int(seed))
        guess = torch.randn((n, n_components + 1), generator=gen)
    return _embed(x, n_components, n_neighbors, metric, n_iters, dense_threshold, guess,
                  tol=_RESIDUAL / (10 * n))
