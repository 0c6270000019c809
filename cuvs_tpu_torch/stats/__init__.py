"""Clustering and embedding quality statistics."""

from cuvs_tpu_torch.stats.scores import silhouette_score, trustworthiness_score

__all__ = ["silhouette_score", "trustworthiness_score"]
