"""Nearest-neighbor search: brute force, IVF-Flat/PQ/SQ/RaBitQ, refine, filters."""
