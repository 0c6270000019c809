"""IVF-PQ through ``cuvs_tpu_torch.neighbors.ivf_pq`` then ``refine.refine``."""

from __future__ import annotations

import torch

from cuvs_tpu_torch.neighbors import ivf_pq, refine
from vsbench import reference, roofline


def build(base: torch.Tensor, cfg: dict, seed: int) -> ivf_pq.Index:
    p = cfg["index"]
    return ivf_pq.build(base, ivf_pq.IndexParams(
        n_lists=p["n_lists"], pq_dim=p["pq_dim"], pq_bits=p["pq_bits"],
        metric=cfg["metric"], seed=int(seed) % (1 << 62)))


# a configuration's ``lut_dtype``: the lookup table's type (the port's default
# when absent: float32, which the fused scan runs as its bf16 table)
_LUT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def searcher(index: ivf_pq.Index, base: torch.Tensor, cfg: dict):
    """``search(q) -> (distances, ids, candidates' scores, candidates' ids)``:
    the refined answer and what the scan handed to refine."""
    s = cfg["search"]
    k, n_cand = s["k"], s["k"] * s["refine_ratio"]
    params = ivf_pq.SearchParams(n_probes=s["n_probes"],
                                 lut_dtype=_LUT[s.get("lut_dtype", "float32")])

    def search(q):
        cand_d, cand = ivf_pq.search(index, q, n_cand, params)
        return (*refine.refine(base, q, cand, k, metric=cfg["metric"]), cand_d, cand)

    return search


def work(index: ivf_pq.Index, base: torch.Tensor, list_sizes: torch.Tensor,
         queries: torch.Tensor, cfg: dict) -> dict:
    s, p = cfg["search"], cfg["index"]
    probes = reference.probe(queries, index.centers, s["n_probes"], cfg["metric"])
    c = roofline.probe_counts(probes, list_sizes)
    return {"pq_scan": roofline.pq_scan(c, base.shape[1], p["pq_dim"], p["pq_bits"],
                                        s["k"] * s["refine_ratio"])}


def _unpack(words: torch.Tensor, bits: int, n_codes: int) -> torch.Tensor:
    """Codes [n, n_codes] from int32 words, code s at bit s * bits."""
    w = words.long() & 0xFFFFFFFF
    w = torch.cat([w, torch.zeros_like(w[:, :1])], 1)
    pos = torch.arange(n_codes, device=w.device) * bits
    lo, sh = pos // 32, pos % 32
    v = (w[:, lo] >> sh) | (w[:, lo + 1] << (32 - sh))
    return v & ((1 << bits) - 1)


def quantizer(index: ivf_pq.Index) -> dict:
    """The centers, rotation and codebooks that the reference follows."""
    return {"centers": index.centers, "rotation": index.rotation, "books": index.pq_centers}


def state(index: ivf_pq.Index) -> dict:
    """What the build made, in row order: each row's list and PQ code, with
    the index's ``quantizer``."""
    n = index.n_rows
    ids = index.lists.ids[:n].long()
    labels = torch.empty(n, dtype=torch.int64, device=ids.device)
    labels[ids] = index.lists.labels[:n].long()
    codes = torch.empty((n, index.pq_dim), dtype=torch.int64, device=ids.device)
    codes[ids] = _unpack(index.sorted_codes[:n], index.pq_bits, index.pq_dim)
    return dict(quantizer(index), ids=ids, labels=labels, codes=codes)
