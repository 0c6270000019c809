"""Spectral embedding and spectral clustering: the port against the JAX
package on the CPU.

Eigenvectors are defined up to sign, and up to a rotation inside a repeated
eigenvalue. So the dense embedding (an exact eigh) is compared column by
column up to sign (atol 1e-4). The LOBPCG path is fed the reference's own
starting block (``jax.random.normal(PRNGKey(seed))``); both solvers stop at
the same residual test (the reference's, ``tol=None``) after the same
number of iterations, so a column
whose eigenvalue is separated from its neighbours' by more than 1e-3 is
compared up to sign (atol 1e-3 on unit columns: the vectors are converged
only to that test's residual), and the spanned subspace by its largest
principal angle (< 1e-2), also where eigenvalues repeat (a disconnected knn
graph has one zero eigenvalue of L per component). Cluster labels are
compared up to a permutation (the packages' k-means draws differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvs_tpu.cluster import spectral as jax_spectral_cluster
from cuvs_tpu.neighbors import knn_graph as jax_kg
from cuvs_tpu.preprocessing import spectral as jax_spectral
from cuvs_tpu_torch.cluster import spectral as spectral_cluster
from cuvs_tpu_torch.preprocessing import spectral

torch.set_num_threads(1)


def _gauss(seed, n, d=3):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _blobs(seed, n, centers, scale):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, len(centers), n)
    x = np.asarray(centers, np.float32)[labels] + rng.standard_normal(
        (n, len(centers[0]))).astype(np.float32) * scale
    return x, labels


def _max_principal_angle(a, b):
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    sv = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.arccos(np.clip(sv.min(), -1.0, 1.0)))


def _columns_up_to_sign(got, want, atol, cols):
    for c in cols:
        s = np.sign((got[:, c] * want[:, c]).sum())
        np.testing.assert_allclose(s * got[:, c], want[:, c], atol=atol, rtol=0)


@pytest.mark.parametrize("seed,n,nc", [(0, 500, 4), (1, 300, 2)])
def test_dense_embedding_matches_reference(seed, n, nc):
    x = _gauss(seed, n)
    want = np.asarray(jax_spectral.spectral_embedding(x, n_components=nc))
    got = spectral.spectral_embedding(x, n_components=nc, device="cpu").numpy()
    assert got.shape == (n, nc) and got.dtype == np.float32
    _columns_up_to_sign(got, want, 1e-4, range(nc))


def _reference_guess(n, width, seed=0):
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (n, width), jnp.float32)))


@pytest.mark.parametrize("seed,n,nc", [(0, 800, 4), (2, 700, 3)])
def test_lobpcg_embedding_matches_reference_from_its_guess(seed, n, nc):
    x = _gauss(seed, n)
    want = np.asarray(jax_spectral.spectral_embedding(x, n_components=nc, dense_threshold=100,
                                                      seed=0))
    got = spectral._embed(torch.from_numpy(x), nc, 15, "euclidean", 300, 100,
                          _reference_guess(n, nc + 1)).numpy()
    # the eigenvalues of L the columns belong to (exact, from the dense path's operator)
    nbrs, _ = jax_kg.build_knn_graph(x, 15, metric="euclidean")
    src = np.concatenate([np.repeat(np.arange(n), 15), np.asarray(nbrs).reshape(-1)])
    dst = np.concatenate([np.asarray(nbrs).reshape(-1), np.repeat(np.arange(n), 15)])
    adj = np.zeros((n, n))
    np.add.at(adj, (src, dst), 1.0)
    dinv = 1.0 / np.sqrt(np.maximum(adj.sum(1), 1.0))
    lam = np.linalg.eigvalsh(np.eye(n) - dinv[:, None] * adj * dinv[None])[1:nc + 1]
    gaps = np.diff(np.concatenate([[-np.inf], lam, [np.inf]]))
    separated = [c for c in range(nc) if min(gaps[c], gaps[c + 1]) > 1e-3]
    assert separated  # the data leaves something to compare column by column
    _columns_up_to_sign(got, want, 1e-3, separated)
    assert _max_principal_angle(got, want) < 1e-2


def test_lobpcg_matches_reference_on_a_repeated_eigenvalue():
    """Three separate blobs: the shifted operator's top eigenvalue 2 has
    multiplicity 3; the solvers may return any basis of that eigenspace."""
    from jax.experimental.sparse.linalg import lobpcg_standard

    x, _ = _blobs(5, 600, [[0, 0, 0], [20, 0, 0], [0, 20, 0]], 0.5)
    n = len(x)
    nbrs, _ = jax_kg.build_knn_graph(x, 10, metric="euclidean")
    src = np.concatenate([np.repeat(np.arange(n), 10), np.asarray(nbrs).reshape(-1)])
    dst = np.concatenate([np.asarray(nbrs).reshape(-1), np.repeat(np.arange(n), 10)])
    dinv = (1.0 / np.sqrt(np.maximum(np.bincount(src, minlength=n), 1.0))).astype(np.float32)

    def jax_matvec(v):
        agg = jnp.zeros_like(v).at[src].add((v * dinv[:, None])[dst])
        return v + dinv[:, None] * agg

    s, d, di = torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(dinv)

    def matvec(v):
        return v + di[:, None] * torch.zeros_like(v).index_add_(0, s, (v * di[:, None])[d])

    guess = _reference_guess(n, 5, seed=3)
    jt, ju, ji = lobpcg_standard(jax_matvec, jnp.asarray(guess.numpy()), m=300)
    tt, tu, ti = spectral._lobpcg_standard(matvec, guess, m=300)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    assert abs(ti - int(ji)) <= 1
    np.testing.assert_allclose(tt.numpy()[:3], 2.0, rtol=1e-5)
    assert _max_principal_angle(tu.numpy()[:, :3], np.asarray(ju)[:, :3]) < 1e-2


def test_public_lobpcg_stop_does_not_loosen_with_n(monkeypatch):
    """The port's deliberate divergence: ``spectral_embedding`` stops LOBPCG
    at residuals below 1e-4 (|A v| + theta) whatever n; the reference's stop
    (tol = f32 eps, scaled by 10 n) is looser, and its eigenpairs less
    converged, on the same graph and start."""
    x = _gauss(6, 3000)
    runs = []
    real = spectral._lobpcg_standard

    def recorded(matvec, guess, m=100, tol=None):
        out = real(matvec, guess, m=m, tol=tol)
        theta, u, it = out
        resid = torch.linalg.norm(matvec(u) - theta[None] * u, dim=0)
        runs.append((resid / (torch.linalg.norm(matvec(u), dim=0) + theta), it))
        return out

    monkeypatch.setattr(spectral, "_lobpcg_standard", recorded)
    spectral.spectral_embedding(x, n_components=4, dense_threshold=100, seed=0, device="cpu")
    spectral._embed(torch.from_numpy(x), 4, 15, "euclidean", 300, 100, _reference_guess(3000, 5))
    (ours, it_ours), (theirs, it_theirs) = runs
    assert float(ours.max()) < 1e-4 < float(theirs.max())
    assert it_ours > it_theirs


def test_lobpcg_rejects_a_wide_block():
    with pytest.raises(ValueError):
        spectral._lobpcg_standard(lambda v: v, torch.ones((10, 2)))


def test_public_lobpcg_path_draws_from_its_generator():
    x = _gauss(4, 400)
    a = spectral.spectral_embedding(x, n_components=2, dense_threshold=100, seed=7, device="cpu")
    b = spectral.spectral_embedding(x, n_components=2, dense_threshold=100, seed=7, device="cpu")
    assert torch.equal(a, b)
    assert torch.allclose(a.norm(dim=0), torch.ones(2), atol=1e-5)


def _agree_up_to_permutation(a, b):
    from scipy.optimize import linear_sum_assignment

    k = int(max(a.max(), b.max())) + 1
    conf = np.zeros((k, k), int)
    np.add.at(conf, (a, b), 1)
    r, c = linear_sum_assignment(-conf)
    return conf[r, c].sum() / len(a)


def test_fit_predict_labels_match_reference_up_to_permutation(monkeypatch):
    """The reference test's blobs (test_extras.py::test_spectral_clustering).
    Their knn graph has two components, so the embedding's two columns are a
    null vector and a vector inside one blob, and k-means' lowest-inertia
    split cuts that blob: the reference's own draw finds the blob split, the
    port's seed-0 draw the other optimum. The reference's k-means++ picks are
    therefore read back (from the rows it selected) and replayed into the
    port's k-means."""
    from cuvs_tpu.cluster import kmeans as jax_kmeans
    from cuvs_tpu_torch.cluster import kmeans

    x, labels_true = _blobs(8, 300, [[0, 0, 0], [8, 8, 8]], 0.4)
    jl, jemb = jax_spectral_cluster.fit_predict(x, 2, seed=0)
    jemb = jnp.asarray(jemb)
    rows = np.asarray(jax_kmeans._kmeans_pp_init(jax.random.PRNGKey(0), jemb, 2))
    picks = [int(np.flatnonzero((np.asarray(jemb) == r).all(1))[0]) for r in rows]
    port_pp = kmeans._kmeans_pp_init
    monkeypatch.setattr(kmeans, "_kmeans_pp_init",
                        lambda gen, xx, k, picks_=None: port_pp(gen, xx, k, picks=picks))
    tl, temb = spectral_cluster.fit_predict(x, 2, seed=0, device="cpu")
    assert len(picks) == 2 and temb.shape == (300, 2)
    assert _agree_up_to_permutation(tl.numpy(), np.asarray(jl)) == 1.0
    assert _agree_up_to_permutation(tl.numpy(), labels_true) > 0.95
