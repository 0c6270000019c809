"""Nearest-neighbor search: brute force, IVF-Flat/PQ/SQ/RaBitQ, CAGRA and its graph builds, refine, filters, and the serving composition (tiered, offloaded, dynamically batched)."""
