"""Shared conv building blocks (counterpart of roma_tpu/models/blocks.py):
the big-RoMa refiner block, and the BasicLayer, ConvStack and instance norm
of XFeat and Tiny RoMa; and :func:`checkpointed`, the rematerialization of
the training path (RoMaNet(remat=True)).

The port's public tensors are NHWC like the JAX package's; torch's conv and
BatchNorm modules take NCHW. :func:`nhwc` runs such a module on an NHWC
tensor through permuted views: an NHWC-contiguous tensor seen as NCHW is
``channels_last``, which cuDNN's convolutions take and keep, so no copy is
made on the way in or out.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.int8 import QuantizedWeight, int8_matmul_quantized


def nhwc(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW module to an NHWC tensor, returning NHWC."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@contextlib.contextmanager
def frozen_bn_stats(module: nn.Module):
    """Leave the BatchNorm running statistics and counters under ``module``
    as they were on entry. A rematerialized forward normalizes with its batch
    statistics as the first forward did, but its BatchNorms would move their
    running statistics a second time; this restores them."""
    bufs = [b for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var, m.num_batches_tracked) if b is not None]
    saved = [b.clone() for b in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(bufs, saved):
                b.copy_(s)


def checkpointed(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` under ``torch.utils.checkpoint``
    (non-reentrant; the JAX package's ``nn.remat``): its activations are
    recomputed in the backward instead of kept, and the recompute runs in
    :func:`frozen_bn_stats`, so a step moves each running statistic once.
    Autocast's state is restored for the recompute by checkpoint itself."""
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), frozen_bn_stats(module)), **kwargs)


class QConv1x1(nn.Conv2d):
    """``nn.Conv2d(c_in, c_out, 1)`` computed through dynamic int8 outside
    training (ops/int8.py; the JAX package's QConv1x1): each pixel's
    channels are a row, quantized with its own scale, against the (c_out,
    c_in) weight. Its parameters are the conv's (weight (c_out, c_in, 1, 1),
    bias), float32 under amp (zoo.set_precision); in training it is the
    float conv, as the JAX package's RefinerBlock takes it (round() has no
    gradient). The int8 weight is cached until the weight changes."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, 1)
        self._quantized = QuantizedWeight()

    def forward(self, x):
        """NCHW in, NCHW out; an NCHW view of NHWC memory (``nhwc``) is
        read and written without a copy."""
        if self.training:
            return super().forward(x)
        w = self.weight.view(self.out_channels, self.in_channels)
        out = int8_matmul_quantized(x.permute(0, 2, 3, 1), *self._quantized(w), self.bias, out_dtype=x.dtype)
        return out.permute(0, 3, 1, 2)


def refiner_block(in_dim: int, out_dim: int, kernel: int = 5, int8: bool = False) -> nn.Sequential:
    """create_block of reference matcher.py:92-122: depthwise KxK conv, BN,
    ReLU, 1x1 conv (:class:`QConv1x1` with ``int8``). Indices 0/1/3 match
    the released checkpoint's keys."""
    return nn.Sequential(
        nn.Conv2d(in_dim, out_dim, kernel, padding=kernel // 2, groups=in_dim),
        nn.BatchNorm2d(out_dim, eps=1e-5, momentum=0.01),
        nn.ReLU(),
        QConv1x1(out_dim, out_dim) if int8 else nn.Conv2d(out_dim, out_dim, 1),
    )


class BasicLayer(nn.Module):
    """Conv(bias=False) -> BatchNorm(affine=False) -> ReLU, the XFeat / Tiny
    RoMa layer (reference tiny.py:15-28). ``layer.0`` / ``layer.1`` are the
    reference checkpoints' keys. BatchNorm takes torch's defaults (eps 1e-5,
    momentum 0.1), the JAX package's ``torch_bn`` (flax momentum 0.9)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.layer = nn.Sequential(
            nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=False),
            nn.BatchNorm2d(c_out, affine=False, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in, NHWC out."""
        return nhwc(self.layer, x)


class ConvStack(nn.Sequential):
    """BasicLayers ``0 .. n-1``, then a 1x1 conv head with bias at index n:
    the reference's ``nn.Sequential`` of the Tiny RoMa matchers, so its keys
    (``coarse_matcher.<i>.layer.{0,1}``, ``coarse_matcher.4``) are the
    port's. NHWC in, NHWC out."""

    def __init__(self, c_in: int, width: int, depth: int, head: int):
        layers = [BasicLayer(c_in if i == 0 else width, width) for i in range(depth)]
        super().__init__(*layers, nn.Conv2d(width, head, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *layers, head = self
        for layer in layers:
            x = layer(x)
        return nhwc(head, x)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over the spatial axes of NHWC ``x``, in
    float32 (biased variance, as torch), returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = x32.var(dim=(1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
