"""Clustering: Lloyd k-means with k-means++ seeding, the balanced k-means IVF trainer, and
single-linkage and spectral clustering."""
