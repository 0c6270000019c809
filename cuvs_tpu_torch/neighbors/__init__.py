"""Nearest-neighbor search: brute force, IVF-Flat, refine, filters."""
