"""Tracing annotations."""
