"""Distances: every pairwise metric (expanded, unexpanded, Haversine, bitwise Hamming), the
fused L2 argmin, and the Gram / kernel-density kernels."""
