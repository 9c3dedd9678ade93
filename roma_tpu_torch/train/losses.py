"""Robust multi-scale losses for big RoMa (counterpart of
roma_tpu/train/losses.py; reference romatch/losses/robust_loss.py:10-161).

Per scale, coarse to fine, so the previous scale's EPE can gate the finer
scale's supervision:
  * coarse (16): cross-entropy of the anchor classification to the anchor
    nearest the GT warp, masked to prob > 0.99, plus certainty BCE;
  * finer scales: generalized Charbonnier ``cs^a ((x/cs)^2+1)^(a/2)`` on the
    EPE, masked, plus certainty BCE;
  * local gating: for scales <= local_largest_scale, supervision is off
    where the previous scale's EPE exceeded ``2/512 * local_dist[scale] *
    scale``.

A function of (corresps, batch) returning (total_loss, metrics), with the
JAX package's metric names; the metrics stay on the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import interpolate, normalized_grid
from .gt_warp import get_gt_warp


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask; 0 when the mask is empty (no host sync)."""
    m = mask.float()
    total = m.sum()
    return torch.where(total > 0, (x * m).sum() / total.clamp(min=1.0), torch.zeros_like(total))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    z, t = logits.float(), targets.float()
    return (z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()


@dataclasses.dataclass(frozen=True)
class RobustLosses:
    """Loss configuration (defaults from experiments/train_roma_outdoor.py:93-99)."""

    ce_weight: float = 0.01
    local_dist: tuple[tuple[int, float], ...] = ((1, 4.0), (2, 4.0), (4, 8.0), (8, 8.0))
    local_largest_scale: int = 8
    depth_interpolation_mode: str = "bilinear"
    relative_depth_error_threshold: float = 0.05
    alpha: float = 0.5
    c: float = 1e-4

    def gm_cls_loss(self, x2, prob, cls_logits, certainty):
        """Coarse anchor classification loss (robust_loss.py:43-61)."""
        c = cls_logits.shape[-1]
        res = round(math.sqrt(c))
        anchors = normalized_grid(res, res, device=cls_logits.device).reshape(c, 2)
        d2 = ((anchors - x2[..., None, :]) ** 2).sum(-1)  # (B, H, W, C)
        gt = d2.argmin(-1)
        logp = torch.log_softmax(cls_logits.float(), dim=-1)
        ce = -logp.gather(-1, gt[..., None])[..., 0]
        return masked_mean(ce, prob > 0.99), bce_with_logits(certainty[..., 0], prob)

    def regression_loss(self, x2, prob, flow, certainty, scale):
        """Generalized Charbonnier EPE loss (robust_loss.py:82-100)."""
        epe = (flow.float() - x2).norm(dim=-1)
        ce_loss = bce_with_logits(certainty[..., 0], prob)
        a = self.alpha
        cs = self.c * scale
        reg = cs**a * ((epe / cs) ** 2 + 1.0) ** (a / 2)
        return masked_mean(reg, prob > 0.99), ce_loss, epe

    def __call__(self, corresps: dict, batch: dict):
        """corresps: {scale: {...}} NHWC; batch: im_A_depth/im_B_depth (B,H,W),
        T_1to2 (B,4,4), K1/K2 (B,3,3). Returns (loss, metrics)."""
        local_dist = dict(self.local_dist)
        tot = 0.0
        metrics: dict[str, torch.Tensor] = {}
        prev_epe = None
        for scale in sorted(corresps, reverse=True):
            sc = corresps[scale]
            flow, certainty = sc["flow"], sc["certainty"]
            h, w = flow.shape[1:3]
            with torch.no_grad():
                x2, prob = get_gt_warp(
                    batch["im_A_depth"], batch["im_B_depth"], batch["T_1to2"],
                    batch["K1"], batch["K2"],
                    depth_interpolation_mode=self.depth_interpolation_mode,
                    relative_depth_error_threshold=self.relative_depth_error_threshold,
                    H=h, W=w,
                )
                if self.local_largest_scale >= scale and prev_epe is not None:
                    near = interpolate(prev_epe[..., None], (h, w), mode="nearest-exact")[..., 0]
                    prob = prob * (near < (2 / 512) * (local_dist[scale] * scale)).float()

            if "gm_cls" in sc:
                cls_loss, cert_loss = self.gm_cls_loss(x2, prob, sc["gm_cls"], sc["gm_certainty"])
                metrics[f"gm_cls_loss_{scale}"] = cls_loss
                metrics[f"gm_certainty_loss_{scale}"] = cert_loss
                tot = tot + self.ce_weight * cert_loss + cls_loss

            reg_loss, cert_loss, epe = self.regression_loss(x2, prob, flow, certainty, scale)
            metrics[f"delta_regression_loss_{scale}"] = reg_loss
            metrics[f"delta_certainty_loss_{scale}"] = cert_loss
            if scale == 1:
                metrics["train_pck_05"] = masked_mean((epe < 0.5 * (2 / 512)).float(), prob > 0.99)
            tot = tot + self.ce_weight * cert_loss + reg_loss
            prev_epe = epe.detach()
        metrics["total_loss"] = tot
        return tot, metrics
