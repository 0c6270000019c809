"""Core containers: packed bitsets."""
