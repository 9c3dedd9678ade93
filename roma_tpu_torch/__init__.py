"""roma_tpu_torch — the RoMa dense matchers (big RoMa and Tiny RoMa) in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``roma_tpu`` (JAX/Pallas on TPU), which stays in the repository as
its reference. This package imports torch, numpy and PIL only; the kernels in
``csrc/`` are built with nvcc at first use on a CUDA tensor (``_ext.py``),
and CPU tensors run each kernel's plain PyTorch version.
"""
from .models import (
    RegressionMatcher,
    RoMaConfig,
    TinyRoMa,
    TinyRoMaNet,
    XFeatBackbone,
    roma_indoor,
    roma_outdoor,
    tiny_roma_v1_outdoor,
)

__all__ = ["RegressionMatcher", "RoMaConfig", "TinyRoMa", "TinyRoMaNet", "XFeatBackbone", "roma_indoor",
           "roma_outdoor", "tiny_roma_v1_outdoor"]
