"""Kernel C: the refiner's x_hat lookup, exact bilinear grid sample.

Replaces roma_tpu/ops/lane_warp.py:_lane_kernel (entry ``lane_warp`` via the
``warp_sample`` dispatcher at roma_tpu/ops/lane_warp.py:406): grid_sample(y,
flow), bilinear, zeros padding, align_corners=False. The JAX package routes
the kernel only for some scales and sizes; here every scale's x_hat on CUDA
takes the kernel.

On the H100 the kernel (csrc/warp_sample.cu) is bound by bytes; its design
note is in the source. A CPU tensor takes the plain version
:func:`warp_sample_reference`.
"""
from __future__ import annotations

import torch

from .. import _ext
from .grid_sample import grid_sample


def warp_sample_reference(y: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the four-tap gather of ops/grid_sample.py."""
    return grid_sample(y, flow)


def warp_sample(y: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """y (B, H, W, C); flow (B, Hq, Wq, 2) float32 in [-1, 1] ->
    (B, Hq, Wq, C) in y's dtype."""
    if y.device.type == "cpu":
        return warp_sample_reference(y, flow)
    what = "warp_sample"
    _ext.require_cuda(what, y, flow)
    b, h, w, c = y.shape
    if flow.ndim != 4 or flow.shape[0] != b or flow.shape[-1] != 2 or flow.dtype != torch.float32:
        raise ValueError(f"{what}: flow must be float32 (B, Hq, Wq, 2), got {flow.dtype} {tuple(flow.shape)}")
    hq, wq = flow.shape[1:3]
    out = torch.empty((b, hq, wq, c), dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    rc = _ext.lib().roma_warp_sample(
        y.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c, hq, wq,
        _ext.dtype_code(y, what), _ext.stream(),
    )
    _ext.check(rc, what)
    warp_sample.launches += 1
    return out


warp_sample.launches = 0
