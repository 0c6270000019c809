"""The plain reference: exact k-NN, exact distances, and the IVF assignment and
PQ encoding worked out again, in plain PyTorch.

Float32 with TF32 off (``exact``), or float64 where a gap is judged; every
product runs in blocks, so the reference fits beside the data. ``tf32=True``
rounds the operands of each product to TF32's 10-bit mantissa first: the
nearest precision below the float32 that the configurations state, which is
the control that the comparison has to refuse. Imports nothing but torch.
"""

from __future__ import annotations

import torch

# elements of one block of scores (1 GiB of float32)
BLOCK = 1 << 28


def exact() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to nearest-even at TF32's 10 mantissa bits."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _dots(q: torch.Tensor, x: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        q, x = round_tf32(q), round_tf32(x)
    return q @ x.T


def knn(base: torch.Tensor, queries: torch.Tensor, k: int, metric: str, tf32: bool = False):
    """Exact k nearest rows of ``base`` per query: (distances [nq, k] float32,
    ids [nq, k] int64), closest first. ``sqeuclidean``: squared L2, smallest
    first; ``inner_product``: the dot, largest first."""
    exact()
    ip = metric == "inner_product"
    n = base.shape[0]
    bq = max(1, min(queries.shape[0], 4096))
    bx = max(k, min(n, BLOCK // bq))
    xn = (base.float() ** 2).sum(1)
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], bq):
        q = queries[q0:q0 + bq].float()
        best_v = torch.full((q.shape[0], 0), 0.0, device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
        for x0 in range(0, n, bx):
            dots = _dots(q, base[x0:x0 + bx].float(), tf32)
            # smaller = closer: -dot, or |x|^2 - 2 q.x (|q|^2 added at the end)
            order = -dots if ip else xn[x0:x0 + bx][None, :] - 2.0 * dots
            v, i = torch.topk(order, min(k, order.shape[1]), dim=1, largest=False)
            best_v, s = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]),
                                   dim=1, largest=False)
            best_i = torch.gather(torch.cat([best_i, i + x0], 1), 1, s)
        if ip:
            out_d.append(-best_v)
        else:
            out_d.append(torch.clamp_min(best_v + (q * q).sum(1, keepdim=True), 0.0))
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def distances(base: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, metric: str):
    """Float64 distances of rows ``ids`` [a, k] to their queries [a, d], and
    the scale that a float32 evaluation of each rounds against (squared L2:
    |q|^2 + |x|^2; inner product: |q| |x|). Ids must be valid rows."""
    q = queries.double()[:, None, :]
    x = base[ids].double()
    if metric == "inner_product":
        d = (q * x).sum(2)
        scale = torch.sqrt((q * q).sum(2) * (x * x).sum(2))
    else:
        d = ((q - x) ** 2).sum(2)
        scale = (q * q).sum(2) + (x * x).sum(2)
    return d, scale


def probe(queries: torch.Tensor, centers: torch.Tensor, n_probes: int, metric: str):
    """The n_probes lists each query searches [nq, n_probes]: closest centers
    by the metric (squared L2, or the largest dot), float32."""
    exact()
    dots = queries.float() @ centers.float().T
    order = -dots if metric == "inner_product" else (centers.float() ** 2).sum(1)[None] - 2 * dots
    return torch.topk(order, n_probes, dim=1, largest=False).indices


def nearest_center(x: torch.Tensor, centers: torch.Tensor, tf32: bool = False,
                   block: int = 1 << 16) -> torch.Tensor:
    """The squared-L2 nearest center of each row [n] int64 (IVF lists are
    k-means clusters under L2 whatever the search metric)."""
    exact()
    c = centers.float()
    cn = (c * c).sum(1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for r0 in range(0, x.shape[0], block):
        out[r0:r0 + block] = (cn[None] - 2.0 * _dots(x[r0:r0 + block].float(), c, tf32)).argmin(1)
    return out


def assign_gap(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
               block: int = 1 << 15) -> float:
    """Largest float64 excess of each row's distance to its given center over
    its distance to the nearest one, over |x|^2 + |c_given|^2 + |c_best|^2."""
    c = centers.double()
    cn = (c * c).sum(1)
    worst = 0.0
    for r0 in range(0, x.shape[0], block):
        xb = x[r0:r0 + block].double()
        xn = (xb * xb).sum(1)
        d = xn[:, None] + cn[None] - 2.0 * xb @ c.T
        best, arg = d.min(1)
        lab = labels[r0:r0 + block].long()
        given = d.gather(1, lab[:, None])[:, 0]
        scale = xn + cn[lab] + cn[arg]
        worst = max(worst, float(((given - best) / scale.clamp_min(1e-300)).max()))
    return worst


def residuals(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
              rotation: torch.Tensor) -> torch.Tensor:
    """(x - center[label]) @ rotation.T in float64."""
    return (x.double() - centers.double()[labels.long()]) @ rotation.double().T


def encode(res: torch.Tensor, books: torch.Tensor, tf32: bool = False,
           block: int = 1 << 13) -> torch.Tensor:
    """Nearest codeword per subspace [n, pq_dim] int64 of residuals [n, rot_dim]
    against books [pq_dim, book, pq_len], in float32 (the control's path)."""
    exact()
    pq_dim, book, pq_len = books.shape
    b = books.float()
    bn = (b * b).sum(2)  # [pq_dim, book]
    out = torch.empty((res.shape[0], pq_dim), dtype=torch.int64, device=res.device)
    for r0 in range(0, res.shape[0], block):
        r = res[r0:r0 + block].float().reshape(-1, pq_dim, pq_len).transpose(0, 1)
        if tf32:
            r, bb = round_tf32(r), round_tf32(b)
        else:
            bb = b
        d = bn[:, None, :] - 2.0 * torch.bmm(r, bb.transpose(1, 2))  # [pq_dim, rows, book]
        out[r0:r0 + block] = d.argmin(2).T
    return out


def encode_gap(res: torch.Tensor, books: torch.Tensor, codes: torch.Tensor,
               block: int = 1 << 13) -> float:
    """Largest float64 excess of a given code's squared distance to its
    residual subspace over the nearest codeword's, over |r_s|^2 + |c_given|^2
    + |c_best|^2. ``res`` [n, rot_dim] float64, ``codes`` [n, pq_dim]."""
    pq_dim, book, pq_len = books.shape
    b = books.double()
    bn = (b * b).sum(2)
    worst = 0.0
    for r0 in range(0, res.shape[0], block):
        r = res[r0:r0 + block].reshape(-1, pq_dim, pq_len)
        rn = (r * r).sum(2)  # [rows, pq_dim]
        d = rn[:, :, None] + bn[None] - 2.0 * torch.einsum("nsl,sbl->nsb", r, b)
        best, arg = d.min(2)
        c = codes[r0:r0 + block].long()
        given = d.gather(2, c[:, :, None])[:, :, 0]
        sidx = torch.arange(pq_dim, device=r.device)[None, :]
        scale = rn + bn[sidx, c] + bn[sidx, arg]
        worst = max(worst, float(((given - best) / scale.clamp_min(1e-300)).max()))
    return worst


def pq_rows(base: torch.Tensor, centers: torch.Tensor, rotation: torch.Tensor,
            books: torch.Tensor, block: int = 1 << 17):
    """Each row's list and PQ reconstruction in the rotated space, worked out
    again from the index's centers, rotation and codebooks: (labels [n] int64,
    rows [n, rot_dim] float32), a row being its list's rotated center plus
    the nearest codeword of each subspace of its rotated residual."""
    labels = nearest_center(base, centers)
    pq_dim, _, pq_len = books.shape
    crot = centers.double() @ rotation.double().T
    b = books.double()
    sidx = torch.arange(pq_dim, device=base.device)[None, :]
    out = torch.empty((base.shape[0], pq_dim * pq_len), dtype=torch.float32, device=base.device)
    for r0 in range(0, base.shape[0], block):
        lab = labels[r0:r0 + block]
        codes = encode(residuals(base[r0:r0 + block], centers, lab, rotation), books)
        out[r0:r0 + block] = (crot[lab] + b[sidx, codes].reshape(lab.shape[0], -1)).float()
    return labels, out


def pq_knn(queries: torch.Tensor, centers: torch.Tensor, rotation: torch.Tensor,
           labels: torch.Tensor, rows: torch.Tensor, n_probes: int, k: int, metric: str):
    """The k best PQ scores among the rows of each query's ``n_probes``
    nearest lists (``pq_rows``): (scores [nq, k] float32, ids [nq, k] int64),
    closest first; squared L2 in the rotated space, or the dot."""
    exact()
    ip = metric == "inner_product"
    n, n_lists = rows.shape[0], centers.shape[0]
    probes = probe(queries, centers, n_probes, metric)
    qrot = queries.float() @ rotation.float().T
    rn = (rows * rows).sum(1)
    bq = max(1, min(queries.shape[0], BLOCK // max(n, 1)))
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], bq):
        q = qrot[q0:q0 + bq]
        probed = torch.zeros((q.shape[0], n_lists), dtype=torch.bool, device=q.device)
        probed.scatter_(1, probes[q0:q0 + bq], True)
        dots = q @ rows.T
        order = -dots if ip else rn[None, :] - 2.0 * dots
        order.masked_fill_(~probed[:, labels], float("inf"))
        v, i = torch.topk(order, k, dim=1, largest=False)
        out_d.append(-v if ip else v + (q * q).sum(1, keepdim=True))
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def pq_distances(queries: torch.Tensor, rotation: torch.Tensor, rows: torch.Tensor,
                 ids: torch.Tensor, metric: str):
    """Float64 PQ scores of rows ``ids`` [a, c] (``pq_rows``) to their
    queries [a, d] in the rotated space, and the scale a float32 evaluation
    rounds against (as ``distances``). Ids must be valid rows."""
    q = (queries.double() @ rotation.double().T)[:, None, :]
    x = rows[ids].double()
    if metric == "inner_product":
        return (q * x).sum(2), torch.sqrt((q * q).sum(2) * (x * x).sum(2))
    return ((q - x) ** 2).sum(2), (q * q).sum(2) + (x * x).sum(2)


def center_error(x: torch.Tensor, centers: torch.Tensor, block: int = 1 << 16) -> float:
    """Sum over rows of the squared L2 distance to the nearest center: the
    k-means objective (float32 products, summed in float64)."""
    exact()
    c = centers.float()
    cn = (c * c).sum(1)
    total = 0.0
    for r0 in range(0, x.shape[0], block):
        xb = x[r0:r0 + block].float()
        d = (cn[None] - 2.0 * xb @ c.T).amin(1) + (xb * xb).sum(1)
        total += float(d.clamp_min(0).double().sum())
    return total


def code_error(res: torch.Tensor, books: torch.Tensor, block: int = 1 << 13) -> float:
    """Sum over rows and subspaces of the squared distance of a residual's
    subvector to its nearest codeword: the codebooks' objective. ``res``
    [n, rot_dim], books [pq_dim, book, pq_len]."""
    exact()
    pq_dim, _, pq_len = books.shape
    b = books.float()
    bn = (b * b).sum(2)
    total = 0.0
    for r0 in range(0, res.shape[0], block):
        r = res[r0:r0 + block].float().reshape(-1, pq_dim, pq_len).transpose(0, 1)
        d = (bn[:, None, :] - 2.0 * torch.bmm(r, b.transpose(1, 2))).amin(2) + (r * r).sum(2)
        total += float(d.clamp_min(0).double().sum())
    return total
