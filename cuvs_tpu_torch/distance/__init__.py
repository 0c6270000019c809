"""Distances: the expanded metrics and the fused L2 argmin."""
