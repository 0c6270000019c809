"""Tracing annotations and index files."""
