"""Benchmark support: datasets, ground truth, throughput timing."""
