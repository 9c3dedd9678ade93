"""Kernel C: the refiner's x_hat lookup, exact bilinear grid sample.

Replaces roma_tpu/ops/lane_warp.py:_lane_kernel (entry ``lane_warp`` via the
``warp_sample`` dispatcher at roma_tpu/ops/lane_warp.py:406): grid_sample(y,
flow), bilinear, zeros padding, align_corners=False. The JAX package routes
the kernel only for some scales and sizes; here every scale's x_hat on CUDA
takes the kernel.

On the H100 the kernel (csrc/warp_sample.cu) is bound by bytes and gives the
plain version's bits; its design note is in the source. The wrapper checks
its arguments in one pure function (:func:`warp_sample_checks`), which also
picks the kernel's path. A CPU tensor takes the plain version
:func:`warp_sample_reference`.
"""
from __future__ import annotations

import torch

from .. import _ext
from ..utils.profiling import spanned
from .grid_sample import grid_sample


def warp_sample_reference(y: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the four-tap gather of ops/grid_sample.py."""
    return grid_sample(y, flow)


VEC_BYTES = 16  # a lane's load and store on the vector path
REGISTER_CS = (3, 5, 7, 9)  # the widths the registers path instantiates
PATH_CODES = {"scalar": 0, "registers": 1, "vector": 2}
INT_MAX = 2**31 - 1  # the kernel indexes elements with 32-bit ints


def warp_sample_checks(what, y, flow):
    """Kernel C's argument contract, in one pass, before any launch: y
    (B, H, W, C) of a supported dtype (TypeError otherwise) with H, W, C >=
    1, flow (B, Hq, Wq, 2) float32, both contiguous and on one device, and
    y's and the output's element counts under 2^31 (ValueError); y not
    requiring a gradient (RuntimeError). Picks the path: "vector" when a
    pixel is whole 16-byte vectors (then y's base must be 16-byte aligned),
    "registers" for C in REGISTER_CS (y's base on a pair of elements: the
    taps are read as aligned pairs), else "scalar". Returns (B, H, W, C, Hq,
    Wq, path)."""
    _ext.dtype_code(y, what)
    if y.ndim != 4 or min(y.shape[1:]) < 1:
        raise ValueError(f"{what}: y must be (B, H, W, C) with H, W, C >= 1, got {tuple(y.shape)}")
    b, h, w, c = y.shape
    if flow.ndim != 4 or flow.shape[0] != b or flow.shape[-1] != 2 or flow.dtype != torch.float32:
        raise ValueError(f"{what}: flow must be float32 (B, Hq, Wq, 2), got {flow.dtype} {tuple(flow.shape)}")
    if not (y.is_contiguous() and flow.is_contiguous() and flow.device == y.device):
        raise ValueError(f"{what}: y and flow must be contiguous and on one device")
    if y.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    hq, wq = flow.shape[1:3]
    if y.numel() > INT_MAX or b * hq * wq * c > INT_MAX:
        raise ValueError(f"{what}: y {tuple(y.shape)} and the output {(b, hq, wq, c)} must each hold under 2^31 "
                         f"elements (32-bit indexing)")
    es = y.element_size()
    if c * es % VEC_BYTES == 0:
        path, align = "vector", VEC_BYTES
    elif c in REGISTER_CS:
        path, align = "registers", 2 * es
    else:
        path, align = "scalar", 1
    if y.data_ptr() % align:
        raise ValueError(f"{what}: the {path} path needs y's base aligned to {align} bytes, got address "
                         f"{y.data_ptr()} % {align} = {y.data_ptr() % align}")
    return b, h, w, c, hq, wq, path


@spanned("roma.ops.warp_sample")
def warp_sample(y: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """y (B, H, W, C); flow (B, Hq, Wq, 2) float32 in [-1, 1] ->
    (B, Hq, Wq, C) in y's dtype."""
    if y.device.type == "cpu":
        return warp_sample_reference(y, flow)
    what = "warp_sample"
    if not y.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {y.device}")
    b, h, w, c, hq, wq, path = warp_sample_checks(what, y, flow)
    out = torch.empty((b, hq, wq, c), dtype=y.dtype, device=y.device)  # fresh: 16-byte aligned
    if out.numel() == 0:
        return out
    rc = _ext.lib().roma_warp_sample(
        y.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c, hq, wq, PATH_CODES[path],
        _ext.dtype_code(y, what), _ext.stream(),
    )
    _ext.check(rc, what)
    warp_sample.launches += 1
    return out


warp_sample.launches = 0
