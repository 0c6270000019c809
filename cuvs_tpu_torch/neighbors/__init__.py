"""Nearest-neighbor search: brute force, IVF-Flat/PQ/SQ/RaBitQ, CAGRA and its graph builds,
refine, filters, the serving composition (tiered, offloaded, dynamically batched), and the long
tail: ball cover, epsilon neighbourhoods, cross-component edges and sparse brute force."""
