"""Dataset files (big-ann .fbin/.ibin/.u8bin/.i8bin) over the port's host library."""

from cuvs_tpu_torch.io.native import BinDataset, load_bin, native_available, write_bin

__all__ = ["BinDataset", "load_bin", "write_bin", "native_available"]
