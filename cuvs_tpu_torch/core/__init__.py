"""Core containers: packed bitsets and the execution-policy handle."""

from cuvs_tpu_torch.core.resources import Resources

__all__ = ["Resources"]
