"""Standalone quantizers: scalar, binary, product and VQ + PQ."""
