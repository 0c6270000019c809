"""The comparison that decides ``correct``.

A search answer is judged against the plain reference (``reference.py``):
- ``dist_gap``: the largest gap between a returned distance and the float64
  distance of the returned row to its query, over the scale that a float32
  evaluation rounds against. It catches a wrong id, a wrong distance, and a
  lower precision on the timed path.
- ``recall_at_10``: hits among the returned ids in the reference's exact k
  nearest, over every query answered; the configuration states its floor.
- ``malformed``: answers with an id outside the rows, a repeated id, or
  distances out of order. Exact: the limit is 0.
Where the index scans codes and the answers are re-ranked (IVF-PQ then
refine), the candidates that the scan hands to refine are judged too, on a
sample of the requests drawn from the seed: the reference works each row's
list and PQ reconstruction out again from the index's centers, rotation and
codebooks and searches the same probed lists exactly by PQ score.
- ``cand_miss``: the share of the reference's candidates that the program's
  lack. It catches a coarse search, grouping, scan or pool merge that drops
  or misranks candidates, and a coarser lookup table.
- ``pq_gap``: the largest gap between a candidate's returned score and its
  float64 score, over the scale that a float32 evaluation rounds against.
A build is judged by the lists and codes of the last index the window
built: the reference takes the index's own centers, rotation and codebooks
and works each row's nearest center and each residual's nearest codeword out
again (``label_gap``, ``code_gap``), and ``missing_rows`` counts the rows the
index does not hold (limit 0). The stage this follows from the program's
state, the training of centers and codebooks, is judged by itself:
``center_gain`` and ``book_gain`` (``build_raw``) weigh the centers and
codebooks against as many drawn from the data, with limits between what
trained indexes read and what an index whose centers and codebooks were left
where they started reads; and by the recall of a search of that index at the
configuration's operating point (an untrained index reads nearly the same
recall, so that floor alone would not tell them apart).
"""

from __future__ import annotations

import dataclasses

import torch

from vsbench import reference

# answers judged per block
_BLOCK = 1 << 15


@dataclasses.dataclass
class Number:
    value: float
    limit: float
    # "max": value <= limit passes; "min": value >= limit passes
    kind: str

    @property
    def passed(self) -> bool:
        return self.value <= self.limit if self.kind == "max" else self.value >= self.limit


def answers(base, pool, gt_ids, answered, metric: str, dist_limit: float) -> dict:
    """Raw numbers of search answers [(pool rows [b], distances, ids), ...]
    against the reference's exact neighbours ``gt_ids`` [n_pool, k], and the
    requests with an answer that is malformed or over ``dist_limit``."""
    rows = torch.cat([a[0] for a in answered])
    req = torch.cat([torch.full((len(a[0]),), j, device=rows.device)
                     for j, a in enumerate(answered)])
    failed = torch.zeros(len(answered), dtype=torch.bool, device=rows.device)
    dist = torch.cat([a[1] for a in answered]).double()
    ids = torch.cat([a[2] for a in answered]).long()
    n, k = base.shape[0], ids.shape[1]
    gap, hits, malformed = 0.0, 0, 0
    for a0 in range(0, rows.shape[0], _BLOCK):
        r, d, i = rows[a0:a0 + _BLOCK], dist[a0:a0 + _BLOCK], ids[a0:a0 + _BLOCK]
        bad = ((i < 0) | (i >= n)).any(1)
        srt = i.sort(1).values
        bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
        step = d[:, 1:] - d[:, :-1]
        bad |= ((step > 0) if metric == "inner_product" else (step < 0)).any(1)
        malformed += int(bad.sum())
        ref, scale = reference.distances(base, pool[r], i.clamp(0, n - 1), metric)
        g = ((d - ref).abs() / scale.clamp_min(1e-300)).amax(1)
        gap = max(gap, float(g.max()))
        failed[req[a0:a0 + _BLOCK][bad | (g > dist_limit)]] = True
        hits += int((i[:, :10, None] == gt_ids[r][:, None, :10]).any(2).sum())
    return {"dist_gap": gap, "recall_at_10": hits / (rows.shape[0] * min(k, 10)),
            "malformed": malformed, "failed_requests": int(failed.sum())}


def candidates(base, pool, q_rows, cand_d, cand_ids, quant: dict, n_probes: int,
               metric: str) -> dict:
    """Raw numbers of the scan's candidates [m, c] of the queries ``pool[q_rows]``
    against the reference's PQ search of the same lists; ``quant``: the
    index's ``centers``, ``rotation`` and ``books``."""
    labels, rows = reference.pq_rows(base, quant["centers"], quant["rotation"], quant["books"])
    n, c = rows.shape[0], cand_ids.shape[1]
    hits, gap = 0, 0.0
    for a0 in range(0, q_rows.shape[0], _BLOCK // 8):
        q = pool[q_rows[a0:a0 + _BLOCK // 8]]
        i, d = cand_ids[a0:a0 + _BLOCK // 8].long(), cand_d[a0:a0 + _BLOCK // 8].double()
        ref_ids = reference.pq_knn(q, quant["centers"], quant["rotation"], labels, rows,
                                   n_probes, c, metric)[1]
        hits += int((ref_ids[:, :, None] == i[:, None, :]).any(2).sum())
        valid = (i >= 0) & (i < n)
        ref, scale = reference.pq_distances(q, quant["rotation"], rows, i.clamp(0, n - 1),
                                            metric)
        g = torch.where(valid, (d - ref).abs() / scale.clamp_min(1e-300), 0.0)
        gap = max(gap, float(g.max()))
    return {"cand_miss": 1.0 - hits / (q_rows.shape[0] * c), "pq_gap": gap}


def search_numbers(raw: dict, limits: dict) -> dict:
    out = {"dist_gap": Number(raw["dist_gap"], limits["dist_gap"], "max"),
           "recall_at_10": Number(raw["recall_at_10"], limits["recall_at_10"], "min"),
           "malformed": Number(raw["malformed"], 0, "max")}
    for key in ("cand_miss", "pq_gap"):
        if key in raw:
            out[key] = Number(raw[key], limits[key], "max")
    return out


def build_raw(base, st: dict, seed: int) -> dict:
    """Raw numbers of a built index's state (``algos.<algo>.state``). The gains
    weigh the training: the share by which the index's centers cut the
    k-means objective of as many centers drawn from the rows by the seed, and
    by which its codebooks cut the codebook objective (on the residuals of
    the reference's lists) of as many codewords drawn from those residuals:
    about 0 untrained, well above 0 trained."""
    n = base.shape[0]
    held = torch.zeros(n, dtype=torch.bool, device=base.device)
    held[st["ids"].clamp(0, n - 1)] = True
    missing = n - int(held.sum()) + int((st["ids"] >= n).sum() + (st["ids"] < 0).sum())
    label_gap = reference.assign_gap(base, st["centers"], st["labels"])
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    drawn = base[torch.randperm(n, generator=g)[:st["centers"].shape[0]].to(base.device)]
    center_gain = 1.0 - (reference.center_error(base, st["centers"])
                         / reference.center_error(base, drawn))
    labels = reference.nearest_center(base, st["centers"])
    pq_dim, book, _ = st["books"].shape
    picks = torch.randint(0, n, (pq_dim, book), generator=g).to(base.device)
    books = _drawn_books(base, st, labels, picks)
    code_gap, fit, fit_drawn = 0.0, 0.0, 0.0
    for r0 in range(0, n, 1 << 17):
        rows = slice(r0, r0 + (1 << 17))
        res = reference.residuals(base[rows], st["centers"], st["labels"][rows], st["rotation"])
        code_gap = max(code_gap, reference.encode_gap(res, st["books"], st["codes"][rows]))
        own = reference.residuals(base[rows], st["centers"], labels[rows], st["rotation"])
        fit += reference.code_error(own, st["books"])
        fit_drawn += reference.code_error(own, books)
    return {"label_gap": label_gap, "code_gap": code_gap, "missing_rows": missing,
            "center_gain": center_gain, "book_gain": 1.0 - fit / fit_drawn}


def _drawn_books(base, st: dict, labels, picks) -> torch.Tensor:
    """Books [pq_dim, book, pq_len] of the rotated residuals' subvectors of
    the rows ``picks`` [pq_dim, book]: subspace s's codeword j is row
    picks[s, j]'s s-th subvector."""
    pq_dim, book, pq_len = st["books"].shape
    rows = picks.reshape(-1)
    res = reference.residuals(base[rows], st["centers"], labels[rows], st["rotation"])
    res = res.reshape(pq_dim, book, pq_dim, pq_len)
    s = torch.arange(pq_dim, device=res.device)
    return res[s, :, s].float()


def build_numbers(raw: dict, limits: dict) -> dict:
    return {"label_gap": Number(raw["label_gap"], limits["label_gap"], "max"),
            "code_gap": Number(raw["code_gap"], limits["code_gap"], "max"),
            "missing_rows": Number(raw["missing_rows"], 0, "max"),
            "center_gain": Number(raw["center_gain"], limits["center_gain"], "min"),
            "book_gain": Number(raw["book_gain"], limits["book_gain"], "min"),
            "recall_at_10": Number(raw["recall_at_10"], limits["recall_at_10"], "min")}


def control_answers(base, pool, reqs, k: int, metric: str) -> list:
    """The control in the program's place: the reference's k-NN of each
    request's queries with TF32 products."""
    out = []
    for rows in reqs:
        d, i = reference.knn(base, pool[rows], k, metric, tf32=True)
        out.append((rows, d, i))
    return out


def control_state(base, st: dict) -> dict:
    """The control in the program's place for a build: each row's list and
    code worked out from the same centers and codebooks with TF32 products."""
    labels = reference.nearest_center(base, st["centers"], tf32=True)
    codes = torch.empty_like(st["codes"])
    for r0 in range(0, base.shape[0], 1 << 17):
        res = reference.residuals(base[r0:r0 + (1 << 17)], st["centers"],
                                  labels[r0:r0 + (1 << 17)], st["rotation"]).float()
        codes[r0:r0 + (1 << 17)] = reference.encode(res, st["books"], tf32=True)
    return dict(st, ids=torch.arange(base.shape[0], device=base.device), labels=labels,
                codes=codes)
