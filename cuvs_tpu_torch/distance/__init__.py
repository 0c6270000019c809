"""Distances: every pairwise metric (expanded, unexpanded, Haversine, bitwise Hamming) and the fused L2 argmin."""
