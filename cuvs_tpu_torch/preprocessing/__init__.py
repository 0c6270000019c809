"""Preprocessing: the standalone quantizers (scalar, binary, product, VQ + PQ), PCA and the
spectral embedding."""
