"""Multi-device indexes and k-means over a list of devices (a device may repeat)."""

from cuvs_tpu_torch.mg.kmeans_mg import fit as kmeans_fit
from cuvs_tpu_torch.mg.snmg import MGIndex, build, build_streaming, default_devices, search

__all__ = ["MGIndex", "build", "build_streaming", "search", "default_devices", "kmeans_fit"]
