"""Shared conv building blocks (counterpart of roma_tpu/models/blocks.py).

The port's public tensors are NHWC like the JAX package's; torch's conv and
BatchNorm modules take NCHW. :func:`nhwc` runs such a module on an NHWC
tensor through permuted views: an NHWC-contiguous tensor seen as NCHW is
``channels_last``, which cuDNN's convolutions take and keep, so no copy is
made on the way in or out.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def nhwc(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW module to an NHWC tensor, returning NHWC."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def refiner_block(in_dim: int, out_dim: int, kernel: int = 5) -> nn.Sequential:
    """create_block of reference matcher.py:92-122: depthwise KxK conv, BN,
    ReLU, 1x1 conv. Indices 0/1/3 match the released checkpoint's keys."""
    return nn.Sequential(
        nn.Conv2d(in_dim, out_dim, kernel, padding=kernel // 2, groups=in_dim),
        nn.BatchNorm2d(out_dim, eps=1e-5, momentum=0.01),
        nn.ReLU(),
        nn.Conv2d(out_dim, out_dim, 1),
    )
