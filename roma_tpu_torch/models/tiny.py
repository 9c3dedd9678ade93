"""Tiny RoMa, the lightweight matcher: the XFeat backbone, a global
correlation matched by a softmax, and coarse and fine refinement CNNs
(counterpart of roma_tpu/models/tiny.py; reference romatch/models/tiny.py:30-304).

NHWC end to end. The global correlation is one float32 (B, N_A, N_B) product
with the softmax over B's pixels, as in the JAX package (a plain product that
JAX also computes outside any kernel, so here it is ``torch.matmul``). In eval
mode the matching softmax is the reference's approximate one (``down=4``
subsampled grid plus the argmax channel, tiny.py:124-136) unless the net is
built with ``exact_softmax``; in train mode it is exact.

``dtype=torch.bfloat16`` runs the net under ``torch.autocast`` over float32
parameters, the JAX package's ``dtype=jnp.bfloat16``; the correlation and the
softmax stay float32 there too.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
from PIL import Image

from ..ops import grid_sample, interpolate, normalized_grid
from ..utils.image import load_image, to_array
from .blocks import ConvStack
from .roma import RegressionMatcher
from .xfeat import XFeatBackbone


def corr_volume_qmajor(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """(B, N0, N1) float32 correlation <f0_i, f1_j> / sqrt(C) of NHWC maps,
    A's pixels first, so the matching softmax reduces over the last axis."""
    b, h0, w0, c = f0.shape
    with torch.autocast(f0.device.type, enabled=False):
        prod = torch.matmul(f0.reshape(b, h0 * w0, c).float(), f1.reshape(b, -1, c).float().transpose(1, 2))
    return prod / math.sqrt(c)


def softmax_pos_embed(cvt: torch.Tensor, grid_hw: tuple[int, int], exact: bool, down: int = 4) -> torch.Tensor:
    """Expected B coordinate of each A pixel from the (B, N0, N1)
    correlation -> (B, N0, 2) in [-1, 1]. ``grid_hw`` is B's coarse grid.
    Exact: a softmax over all N1 (reference tiny.py:138-139). Approximate:
    a softmax over every ``down``-th row and column of B's grid plus the
    best match's own logit, whose weight goes to the best match's
    coordinate (reference tiny.py:124-136)."""
    h1, w1 = grid_hw
    b, n0, n1 = cvt.shape
    grid = normalized_grid(h1, w1, cvt.device).reshape(n1, 2)
    with torch.autocast(cvt.device.type, enabled=False):
        if exact:
            return torch.matmul(torch.softmax(cvt, dim=-1), grid)
        grid_lr = normalized_grid(h1 // down, w1 // down, cvt.device).reshape(-1, 2)
        best_val, best = cvt.max(dim=-1, keepdim=True)
        low = cvt.reshape(b, n0, h1, w1)[:, :, ::down, ::down].reshape(b, n0, -1)
        p = torch.softmax(torch.cat((low, best_val), dim=-1), dim=-1)
        return torch.matmul(p[..., :-1], grid_lr) + p[..., -1:] * grid[best[..., 0]]


@functools.lru_cache(maxsize=64)
def _to_norm(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(2/W, 2/H, 1): a pixel delta -> normalized flow, certainty as is;
    kept on ``device`` so a call makes no host-to-device copy."""
    with torch.inference_mode(False):
        return torch.tensor([2.0 / w, 2.0 / h, 1.0]).to(device)


class TinyRoMaNet(nn.Module):
    """The net: (im_A, im_B) NHWC images in [0, 1], H and W multiples of 32
    (the caller resizes) -> the corresps pyramid ``{8: {"flow",
    "certainty"}, 4: {...}}``, NHWC, with ``corr_volume`` at scale 8 in
    train mode.

    ``train_mode`` sets the module's initial mode; afterwards ``train()`` /
    ``eval()`` decide, as for any module. With ``freeze_xfeat`` (the
    default, as the reference trains) the backbone's outputs are detached
    and it stays in eval mode under ``train()``, so its BatchNorms keep
    their running statistics (the JAX package builds XFeat with
    ``train=train_mode and not freeze_xfeat``)."""

    def __init__(self, exact_softmax: bool = False, train_mode: bool = False, freeze_xfeat: bool = True):
        super().__init__()
        self.exact_softmax = exact_softmax
        self.freeze_xfeat = freeze_xfeat
        self.xfeat = XFeatBackbone()
        self.coarse_matcher = ConvStack(64 + 64 + 2, 256, 4, 3)
        self.fine_matcher = ConvStack(24 + 24 + 2, 64, 4, 3)
        self.train(train_mode)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_xfeat:
            self.xfeat.eval()
        return self

    def forward(self, im_A: torch.Tensor, im_B: torch.Tensor) -> dict:
        b, h, w, _ = im_B.shape
        if im_A.shape == im_B.shape:  # one backbone pass (reference tiny.py:283-287)
            fine, coarse = self.xfeat(torch.cat((im_A, im_B)))
            (f_a_f, f_b_f), (f_a_c, f_b_c) = fine.chunk(2), coarse.chunk(2)
        else:
            f_a_f, f_a_c = self.xfeat(im_A)
            f_b_f, f_b_c = self.xfeat(im_B)
        if self.freeze_xfeat:
            f_a_f, f_a_c, f_b_f, f_b_c = (t.detach() for t in (f_a_f, f_a_c, f_b_f, f_b_c))

        hc, wc = f_a_c.shape[1:3]
        cvt = corr_volume_qmajor(f_a_c, f_b_c)
        # the matching grid is B's coarse map (reference pos_embed, tiny.py:116-122)
        grid_b = tuple(f_b_c.shape[1:3])
        coarse_warp = softmax_pos_embed(cvt, grid_b, self.exact_softmax or self.training).reshape(b, hc, wc, 2)
        to_norm = _to_norm(h, w, im_B.device)

        f_b_c_w = grid_sample(f_b_c, coarse_warp)
        delta = self.coarse_matcher(torch.cat((f_a_c, f_b_c_w, coarse_warp.to(f_a_c.dtype)), dim=-1))
        coarse = torch.cat((coarse_warp, torch.zeros_like(coarse_warp[..., :1])), dim=-1) + delta.float() * to_norm
        corresps = {8: {"flow": coarse[..., :2], "certainty": coarse[..., 2:]}}
        if self.training:
            corresps[8]["corr_volume"] = cvt

        coarse_up = interpolate(coarse, tuple(f_a_f.shape[1:3]), mode="bilinear").detach()  # reference tiny.py:299
        f_b_f_w = grid_sample(f_b_f, coarse_up[..., :2])
        fine_delta = self.fine_matcher(torch.cat((f_a_f, f_b_f_w, coarse_up[..., :2].to(f_a_f.dtype)), dim=-1))
        fine = coarse_up + fine_delta.float() * to_norm
        corresps[4] = {"flow": fine[..., :2], "certainty": fine[..., 2:]}
        return corresps


class TinyRoMa:
    """The public Tiny RoMa matcher (reference tiny.py:30-304), with the JAX
    package's API: ``match`` -> (warp (B, H, W, 4) = (x_A, y_A, x_B, y_B) in
    [-1, 1], certainty (B, H, W)) at A's input resolution; ``sample`` in
    ``sample_mode`` with ``sample_thresh`` 0.05; ``to_pixel_coordinates``;
    ``visualize_warp``. ``dtype`` is the compute dtype: float32, or
    bfloat16 under autocast over the net's float32 parameters."""

    input_normalized = False  # match takes [0, 1] images (reference tiny.py:72-79)

    def __init__(self, net: TinyRoMaNet, sample_mode: str = "threshold_balanced",
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        self.net = net.eval()
        self.sample_mode, self.sample_thresh = sample_mode, 0.05
        self.dtype = dtype
        self.device = next(net.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @staticmethod
    def _proc_hw(x) -> tuple[int, int]:
        """Each image's own /32 grid (reference preprocess_tensor,
        tiny.py:72-79): resizing A to B's grid would change A's aspect."""
        return (x.shape[1] // 32) * 32, (x.shape[2] // 32) * 32

    def _run(self, im_A: torch.Tensor, im_B: torch.Tensor) -> dict:
        im_A = interpolate(im_A, self._proc_hw(im_A), mode="bilinear")
        im_B = interpolate(im_B, self._proc_hw(im_B), mode="bilinear")
        with torch.autocast(self.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32):
            return self.net(im_A, im_B)

    def _as_batch(self, im) -> torch.Tensor:
        t = im if torch.is_tensor(im) else torch.from_numpy(np.asarray(im, np.float32))
        return t.to(self.device, self.dtype)

    @torch.inference_mode()
    def forward(self, batch: dict) -> dict:
        """The corresps pyramid of a batch dict {im_A, im_B} (NHWC, [0, 1])."""
        return self._run(self._as_batch(batch["im_A"]), self._as_batch(batch["im_B"]))

    @torch.inference_mode()
    def match(self, im_A, im_B, *, batched: bool = True):
        """Dense match of paths, PIL images, or NHWC / HWC arrays or tensors
        in [0, 1]. A single pair (a path, a PIL image or an HWC array), or
        any input with ``batched=False``, comes back without the batch axis
        (the first pair's result)."""
        if isinstance(im_A, (str, Path, Image.Image)):
            im_A, im_B = (to_array(load_image(im))[None] for im in (im_A, im_B))
            batched = False
        im_A, im_B = self._as_batch(im_A), self._as_batch(im_B)
        if im_A.ndim == 3:
            im_A, im_B = im_A[None], im_B[None]
            batched = False
        h0, w0 = im_A.shape[1:3]
        corresps = self._run(im_A, im_B)
        flow = interpolate(corresps[4]["flow"], (h0, w0), mode="bilinear")
        cert = interpolate(corresps[4]["certainty"], (h0, w0), mode="bilinear")
        grid = normalized_grid(h0, w0, self.device).expand(flow.shape[0], h0, w0, 2)
        warp, cert = torch.cat((grid, flow), dim=-1), torch.sigmoid(cert[..., 0])
        return (warp, cert) if batched else (warp[0], cert[0])

    def sample(self, matches, certainty, num: int = 5000, key: torch.Generator | int | None = None,
               generator: torch.Generator | None = None):
        """Sparse sampling in ``sample_mode`` (reference tiny.py:234-264), as
        :meth:`RegressionMatcher.sample` draws it (``key``: a Generator, or
        an int seeding a fresh one on this matcher's device)."""
        return RegressionMatcher.sample(self, matches, certainty, num, key=key, generator=generator)

    to_pixel_coordinates = RegressionMatcher.to_pixel_coordinates
    _to_pixel = staticmethod(RegressionMatcher._to_pixel)

    def visualize_warp(self, warp, certainty, im_A, im_B, save_path=None, symmetric: bool = False):
        """Image B sampled through the warp into A's frame, blended to white
        where the certainty is low (reference tiny.py:142-176); with
        ``symmetric`` a side-by-side (H, 2W, 4) warp, A sampled into B's
        frame beside it. :meth:`RegressionMatcher.visualize_warp` with the
        JAX TinyRoMa's argument order and default (``match`` returns a
        one-directional warp)."""
        return RegressionMatcher.visualize_warp(self, warp, certainty, im_A, im_B, symmetric=symmetric,
                                                save_path=save_path)


def resize_pil(im, size_hw) -> Image.Image:
    """Load and resize to (h, w) with PIL's default filter, as the reference
    and ``visualize_warp`` do."""
    return load_image(im).resize((size_hw[1], size_hw[0]))
