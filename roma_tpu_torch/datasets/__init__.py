"""Training data on the host (counterpart of roma_tpu/datasets): the
MegaDepth and ScanNet pair datasets, their transforms and the prefetching
loader. NumPy and PIL only; h5py is imported by MegaDepth's depth read."""
from .megadepth import ConcatDataset, MegadepthBuilder, MegadepthScene
from .scannet import ScanNetBuilder, ScanNetScene

__all__ = [
    "ConcatDataset",
    "MegadepthBuilder",
    "MegadepthScene",
    "ScanNetBuilder",
    "ScanNetScene",
]
