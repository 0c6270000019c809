"""Clustering: Lloyd k-means with k-means++ seeding, and the balanced k-means IVF trainer."""
