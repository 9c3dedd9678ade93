"""RegressionMatcher, the public big-RoMa API (counterpart of
roma_tpu/models/roma.py).

``match`` runs the two-pass pipeline: a coarse pass at the coarse resolution
(DINOv2 + GP + decoder, scales 16..1), then a refine-only pass at
``upsample_res`` (scales 8..1, seeded with the finest coarse flow), certainty
attenuation from the first pass's scale-16 logits, out-of-range ->
certainty 0, clamp to [-1, 1], and the warp: side by side when symmetric,
A -> B otherwise. With ``upsample_preds=False`` the coarse pass's finest
flow and certainty are the result, bilinearly resized to the output
resolution (the coarse resolution then).
Path and PIL inputs take one route on every device (``_prep_pair``).
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..ops import (balanced_sample, grid_sample, interpolate, normalized_grid, resize_normalize,
                   to_normalized_coords, to_pixel_coords)
from ..utils.image import load_image, to_array
from ..utils.profiling import annotate
from ..utils.staging import PinnedStaging
from .matcher import RoMaNet


class RegressionMatcher:
    """The two-pass matcher of ``roma_outdoor``, with the JAX package's
    arguments and defaults: coarse pass at (h, w), refinement at
    ``upsample_res`` (``upsample_preds``), ``symmetric`` side-by-side warps,
    certainty attenuation by the coarse logits (``attenuate_cert``),
    ``sample_mode`` / ``sample_thresh`` for :meth:`sample`. The net is built
    already, so its dtype is its own; ``coarse_dtype``, when given, casts
    DINOv2's parameters (in place, on ``net``) so that the coarse tokens are
    computed in it, as the JAX package's ``coarse_dtype`` does."""

    input_normalized = True  # match takes ImageNet-normalized images

    def __init__(
        self,
        net: RoMaNet,
        h: int = 560,
        w: int = 560,
        sample_mode: str = "threshold_balanced",
        upsample_preds: bool = True,
        symmetric: bool = True,
        sample_thresh: float = 0.05,
        attenuate_cert: bool = True,
        upsample_res: tuple[int, int] = (864, 864),
        coarse_dtype: torch.dtype | None = None,
        seed: int = 0,
    ):
        if h % 14 or w % 14:
            raise ValueError(f"coarse res must be a multiple of 14, got {(h, w)}")
        self.net = net.eval()
        if coarse_dtype is not None:
            net.encoder.dinov2.to(coarse_dtype)
        self.h_resized, self.w_resized = h, w
        self.sample_mode, self.sample_thresh = sample_mode, sample_thresh
        self.upsample_preds, self.symmetric, self.attenuate_cert = upsample_preds, symmetric, attenuate_cert
        self.upsample_res = tuple(upsample_res)
        p = next(net.encoder.cnn.parameters())
        self.device, self.dtype = p.device, p.dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._staging = PinnedStaging()

    def get_output_resolution(self) -> tuple[int, int]:
        return self.upsample_res if self.upsample_preds else (self.h_resized, self.w_resized)

    def _match_coarse(self, im_A, im_B, out_hw, gm_logit_bias=None):
        hs, ws = im_A.shape[1:3]
        sf = math.sqrt(hs * ws / 560.0**2)
        corresps = self.net(im_A, im_B, symmetric=self.symmetric, scale_factor=sf, gm_logit_bias=gm_logit_bias)
        low = interpolate(corresps[16]["certainty"], out_hw, mode="bilinear")
        low = 0.5 * low * (low < 0)
        return low, corresps[1]["flow"], corresps[1]["certainty"]

    def _match_upsample(self, im_A, im_B, flow, certainty):
        hs, ws = im_A.shape[1:3]
        sf = math.sqrt(hs * ws / 560.0**2)
        corresps = self.net(im_A, im_B, symmetric=self.symmetric, upsample=True, flow=flow,
                            certainty=certainty, scale_factor=sf)
        return corresps[1]["flow"], corresps[1]["certainty"]

    def _assemble(self, flow, certainty, low_res_certainty):
        """Final warp assembly (reference matcher.py:891-929)."""
        b, hs, ws, _ = flow.shape
        cert = torch.sigmoid((certainty - low_res_certainty)[..., 0])
        wrong = (flow.abs() > 1).any(dim=-1)
        cert = torch.where(wrong, torch.zeros_like(cert), cert)
        flow = flow.clamp(-1, 1)
        grid = normalized_grid(hs, ws, device=flow.device)
        if not self.symmetric:
            return torch.cat((grid.expand(b, hs, ws, 2), flow), dim=-1), cert
        grid = grid.expand(b // 2, hs, ws, 2)
        a2b, b2a = flow.chunk(2)
        q_warp = torch.cat((grid, a2b), dim=-1)
        s_warp = torch.cat((b2a, grid), dim=-1)
        return torch.cat((q_warp, s_warp), dim=2), torch.cat(cert.chunk(2), dim=2)

    def _prep_pair(self, pil_A, pil_B, hws):
        """Both images at each (h, w) of ``hws``, ImageNet-normalized in the
        net's dtype on its device: [(im_A, im_B), ...], each (1, h, w, 3).
        Each image's pixels go to the device once (``utils.staging``); the
        bicubic resize is Pillow's, bit for bit (``ops.resize_normalize``:
        Kernel M on the card, its plain version elsewhere), one call a size
        over both images when their sizes match."""
        x_A, x_B = np.asarray(pil_A), np.asarray(pil_B)
        if x_A.shape == x_B.shape:
            batches = [self._staging.to_device((x_A, x_B), self.device, stack=True)]
        else:
            batches = [x[None] for x in self._staging.to_device((x_A, x_B), self.device)]
        out = []
        for hw in hws:
            with annotate("roma.match.resize"):
                ims = [resize_normalize(x, hw, self.dtype) for x in batches]
            out.append((ims[0][:1], ims[-1][-1:]))
        return out

    def _as_batch(self, im):
        t = im if torch.is_tensor(im) else torch.from_numpy(np.asarray(im, np.float32))
        t = t.to(self.device, self.dtype)
        return t[None] if t.ndim == 3 else t

    @torch.inference_mode()
    def match(self, im_A_input, im_B_input, *, im_A_high_res=None, im_B_high_res=None,
              batched: bool = True, gm_logit_bias=None):
        """Dense two-view match -> (warp, certainty).

        Accepts paths / PIL images or pre-normalized NHWC arrays or
        tensors at the coarse resolution. PIL inputs are resized with
        Pillow's bicubic arithmetic, bit for bit PIL's bytes, by
        ``ops.resize_normalize`` on every device (the kernel on the card,
        its plain version on the CPU). Returns the warp,
        (x_A, y_A, x_B, y_B) in [-1, 1], and its certainty at
        :meth:`get_output_resolution`: (B, H, 2W, 4) and (B, H, 2W) side by
        side when symmetric, (B, H, W, 4) and (B, H, W) otherwise. A single
        pair (PIL, path or an HWC array), or any input with
        ``batched=False``, comes back without the batch axis (the first
        pair's result).

        Spans (``utils.profiling``): ``roma.match``; inside it
        ``roma.match.prep`` (load, copy, ``roma.match.resize`` for each
        size: the call of both images' resize and normalization, on the card
        its launch), ``roma.match.coarse`` and ``roma.match.upsample``, each
        with its device time and the net's ``roma.net.*`` module spans
        inside it (``models/encoders.py``, ``models/matcher.py``).
        """
        with annotate("roma.match"):
            return self._match(im_A_input, im_B_input, im_A_high_res, im_B_high_res, batched, gm_logit_bias)

    def _match(self, im_A_input, im_B_input, im_A_high_res, im_B_high_res, batched, gm_logit_bias):
        with annotate("roma.match.prep"):
            im_A, im_B, im_A_u, im_B_u, unbatch = self._prep_inputs(im_A_input, im_B_input, im_A_high_res,
                                                                    im_B_high_res)
            unbatch = unbatch or not batched
            if gm_logit_bias is not None:
                gm_logit_bias = torch.as_tensor(gm_logit_bias, device=self.device, dtype=torch.float32)
        out_hw = self.get_output_resolution()
        with annotate("roma.match.coarse", device=True):
            low, flow, cert = self._match_coarse(im_A, im_B, out_hw, gm_logit_bias)
        if not self.attenuate_cert:
            low = torch.zeros_like(low)
        if self.upsample_preds:
            if im_A_u is None:  # array input without high-res copies: bicubic upsample
                im_A_u = interpolate(im_A, out_hw, mode="bicubic")
                im_B_u = interpolate(im_B, out_hw, mode="bicubic")
            with annotate("roma.match.upsample", device=True):
                flow, cert = self._match_upsample(im_A_u, im_B_u, flow, cert)
        else:
            flow = interpolate(flow, out_hw, mode="bilinear")
            cert = interpolate(cert, out_hw, mode="bilinear")
        warp, certainty = self._assemble(flow, cert, low)
        if unbatch:
            return warp[0], certainty[0]
        return warp, certainty

    def _prep_inputs(self, im_A_input, im_B_input, im_A_high_res, im_B_high_res):
        """The inputs of both passes on the device: (im_A, im_B, im_A_u,
        im_B_u, unbatch), the upsample pass's None where it takes the coarse
        inputs upsampled on the device."""
        out_hw = self.get_output_resolution()
        im_A_u = im_B_u = None
        # both passes' inputs are made before the coarse pass, from one copy
        # of each image
        if isinstance(im_A_input, (str, Path, Image.Image)):
            pil_A, pil_B = load_image(im_A_input), load_image(im_B_input)
            hws = [(self.h_resized, self.w_resized)] + ([out_hw] if self.upsample_preds else [])
            preps = self._prep_pair(pil_A, pil_B, hws)
            im_A, im_B = preps[0]
            if self.upsample_preds:
                im_A_u, im_B_u = preps[1]
            unbatch = True
        else:
            unbatch = len(im_A_input.shape) == 3
            im_A, im_B = self._as_batch(im_A_input), self._as_batch(im_B_input)
            if im_A.shape != im_B.shape or im_A.shape[-1] != 3:
                raise ValueError(f"array inputs must be NHWC RGB of one size, got "
                                 f"{tuple(im_A.shape)} and {tuple(im_B.shape)}")
            if im_A.shape[1] % 14 or im_A.shape[2] % 14:
                raise ValueError("array inputs must have H, W divisible by 14")
            if im_A_high_res is not None and self.upsample_preds:
                im_A_u, im_B_u = self._as_batch(im_A_high_res), self._as_batch(im_B_high_res)
        return im_A, im_B, im_A_u, im_B_u, unbatch

    def sample(self, matches, certainty, num: int = 10000, key: torch.Generator | int | None = None,
               generator: torch.Generator | None = None):
        """Sparse sampling in ``sample_mode`` (reference matcher.py:552-573).

        ``key``, as the JAX package's ``sample(key=)`` takes it: a
        ``torch.Generator``, or an int that seeds a fresh generator on this
        matcher's device, for draws independent of this instance's history
        (one per pair and repeat in a benchmark). ``generator`` is the same
        as a Generator ``key``. Default: the instance's own generator."""
        if key is not None and generator is not None:
            raise ValueError("pass key or generator, not both")
        gen = key if key is not None else generator
        if isinstance(gen, int):
            gen = torch.Generator(device=self.device).manual_seed(gen)
        m = torch.as_tensor(matches).reshape(-1, 4)
        c = torch.as_tensor(certainty).reshape(-1)
        return balanced_sample(m, c, num, generator=gen if gen is not None else self.generator,
                               thresh=self.sample_thresh, mode=self.sample_mode)

    def to_pixel_coordinates(self, coords, H_A, W_A, H_B=None, W_B=None):
        coords = torch.as_tensor(coords)
        if coords.shape[-1] == 2:
            return to_pixel_coords(coords, H_A, W_A)
        return to_pixel_coords(coords[..., :2], H_A, W_A), to_pixel_coords(coords[..., 2:], H_B, W_B)

    def to_normalized_coordinates(self, coords, H_A, W_A, H_B, W_B):
        if isinstance(coords, (list, tuple)):
            k_A, k_B = torch.as_tensor(coords[0]), torch.as_tensor(coords[1])
        else:
            coords = torch.as_tensor(coords)
            k_A, k_B = coords[..., :2], coords[..., 2:]
        return to_normalized_coords(k_A, H_A, W_A), to_normalized_coords(k_B, H_B, W_B)

    def match_keypoints(self, x_A, x_B, warp, certainty, return_tuple=True, return_inds=False, max_dist=0.005,
                        cert_th=0):
        """Warp-based mutual-nearest keypoint matching (reference
        matcher.py:732-773). x_A (N, 2), x_B (M, 2) normalized keypoints;
        computed on the warp's device, returned as numpy arrays as the JAX
        package does (the output is ragged)."""
        warp = torch.as_tensor(warp)
        dev = warp.device
        x_A, x_B = torch.as_tensor(x_A, device=dev).float(), torch.as_tensor(x_B, device=dev).float()
        certainty = torch.as_tensor(certainty, device=dev)
        a2b = grid_sample(warp[None, ..., -2:], x_A[None, None])[0, 0]  # (N, 2)
        cert = grid_sample(certainty[None, ..., None], x_A[None, None])[0, 0, :, 0]
        d = torch.linalg.norm(a2b[:, None] - x_B[None], dim=-1)  # (N, M)
        mnn = ((d == d.min(dim=-1, keepdim=True).values) & (d == d.min(dim=-2, keepdim=True).values)
               & (cert[:, None] > cert_th) & (d < max_dist))
        inds_A, inds_B = (i.cpu().numpy() for i in torch.nonzero(mnn, as_tuple=True))
        k_A, k_B = x_A.cpu().numpy()[inds_A], x_B.cpu().numpy()[inds_B]
        if return_tuple:
            return (inds_A, inds_B) if return_inds else (k_A, k_B)
        return np.concatenate((inds_A, inds_B) if return_inds else (k_A, k_B), axis=-1)

    def conf_from_fb_consistency(self, flow_forward, flow_backward, th=2):
        """Forward-backward consistency mask (reference matcher.py:672-699):
        1 where the backward flow, sampled at the forward flow, comes back
        within ``th`` pixels (of the larger side), else 0; (B,) H, W."""
        ff, fb = torch.as_tensor(flow_forward), torch.as_tensor(flow_backward)
        has_batch = ff.ndim == 4
        if not has_batch:
            ff, fb = ff[None], fb[None]
        h, w = ff.shape[1:3]
        coords_fb = grid_sample(fb, ff)
        diff = torch.linalg.norm(normalized_grid(h, w, ff.device) - coords_fb, dim=-1)
        in_th = (diff < 2 * th / max(h, w)).float()
        return in_th if has_batch else in_th[0]

    def visualize_warp(self, warp, certainty, im_A, im_B, symmetric=True, save_path=None):
        """Certainty-weighted cross-warped image pair (reference
        matcher.py:936-986): each image sampled through the warp into the
        other's frame, blended to white where the certainty is low; saved as
        a PNG when ``save_path`` is given. Runs on the warp's device."""
        warp = torch.as_tensor(warp)
        h, w2 = warp.shape[:2]
        w = w2 // 2 if symmetric else w2
        x_A, x_B = (torch.from_numpy(to_array(load_image(im).resize((w, h)))).to(warp.device) for im in (im_A, im_B))
        warp_im = grid_sample(x_B[None], warp[None, :, :w, 2:])[0]
        if symmetric:
            warp_im = torch.cat((warp_im, grid_sample(x_A[None], warp[None, :, w:, :2])[0]), dim=1)
        cert = torch.as_tensor(certainty, device=warp.device)[..., None]
        vis = cert * warp_im + (1 - cert) * torch.ones_like(warp_im)
        if save_path is not None:
            arr = (vis.clamp(0, 1) * 255).cpu().numpy().astype(np.uint8)
            Image.fromarray(arr).save(save_path)
        return vis
