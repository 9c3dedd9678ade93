"""Tiny RoMa's training losses (counterpart of roma_tpu/train/losses_tiny.py;
reference romatch/losses/robust_loss_tiny_roma.py).

Two terms:
  * ``corr_volume_loss``: a bidirectional InfoNCE-style NLL (log-softmax over
    both axes of the global correlation, inverse temperature 10) on the
    mutually nearest GT cells of the forward and backward GT warps
    (robust_loss_tiny_roma.py:50-61, 129-152), as a dense mask;
  * a regression loss per scale with optional ``epe_mask_prob_th``
    certainty gating and ``cert_only_on_consistent_depth`` masking
    (robust_loss_tiny_roma.py:64-92).

The reference indexes its (B, N_B, N_A) NLL volume as ``nll[b, i_A, j_B]``;
the JAX package keeps that, and so does the port: the mask is transposed
against the port's (B, N_A, N_B) volume.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import batched_grid
from .gt_warp import get_gt_warp
from .losses import masked_mean


def bce_with_logits_masked(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Binary cross-entropy with logits, float32, averaged over ``mask``
    (over everything when None)."""
    z, t = logits.float(), targets.float()
    elem = z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))
    return elem.mean() if mask is None else masked_mean(elem, mask)


def mutual_nearest_mask(gt_warp, gt_warp_back, grid, thresh: float = 0.01) -> torch.Tensor:
    """(B, N_A, N_B) mask of the mutually nearest GT cell pairs.

    gt_warp: (B, N_A, 2) A's cells mapped into B; gt_warp_back: (B, N_B, 2)
    B's cells mapped into A; grid: (N, 2) cell centres. The distances are
    norms of differences, as the JAX package computes them: the ``==``
    against each row's minimum and the ``< thresh`` tests depend on it."""
    d_b = torch.linalg.vector_norm(gt_warp[:, :, None] - grid[None, None], dim=-1)
    d_a = torch.linalg.vector_norm(grid[None, :, None] - gt_warp_back[:, None], dim=-1)
    return ((d_b == d_b.min(dim=-1, keepdim=True).values) & (d_a == d_a.min(dim=-2, keepdim=True).values)
            & (d_b < thresh) & (d_a < thresh))


@dataclasses.dataclass(frozen=True)
class TinyRobustLosses:
    """Loss configuration, with the JAX package's fields and defaults. A
    function of (corresps, batch) -> (total loss, metrics); the metrics
    stay on the device."""

    ce_weight: float = 0.01
    local_dist: tuple[tuple[int, float], ...] = ()
    depth_interpolation_mode: str = "bilinear"
    relative_depth_error_threshold: float = 0.05
    alpha: float = 0.5
    c: float = 1e-4
    epe_mask_prob_th: float | None = None
    cert_only_on_consistent_depth: bool = False
    inv_temp: float = 10.0

    def corr_volume_loss(self, mnn_mask, cvt):
        """cvt: (B, N_A, N_B) correlation (models/tiny.py's layout)."""
        z = self.inv_temp * cvt.float()
        nll = -torch.log_softmax(z, dim=-1) - torch.log_softmax(z, dim=-2)
        # the reference's [b, i_A, j_B] on its (B, N_B, N_A) volume
        return masked_mean(nll, mnn_mask.transpose(-1, -2))

    def regression_loss(self, x2, prob, flow, certainty, scale):
        epe = (flow.float() - x2).norm(dim=-1)
        local_dist = dict(self.local_dist)
        if scale in local_dist:
            prob = prob * (epe < (2 / 512) * (local_dist[scale] * scale)).to(prob.dtype)
        gt_cert = prob
        if self.epe_mask_prob_th is not None:
            gt_cert = prob * (epe < scale * self.epe_mask_prob_th).to(prob.dtype)
        mask = prob > 0 if self.cert_only_on_consistent_depth else None
        ce_loss = bce_with_logits_masked(certainty[..., 0], gt_cert, mask)
        cs = self.c * scale
        reg = cs**self.alpha * ((epe / cs) ** 2 + 1.0) ** (self.alpha / 2)
        reg_loss = masked_mean(reg, prob > 0.99)
        pck_05 = masked_mean((epe < 0.5 * (2 / 512)).float(), prob > 0.99)
        return reg_loss, ce_loss, pck_05

    def __call__(self, corresps: dict, batch: dict):
        tot = 0.0
        metrics: dict[str, torch.Tensor] = {}
        for scale in sorted(corresps, reverse=True):
            sc = corresps[scale]
            flow, certainty = sc["flow"], sc["certainty"]
            b, h, w, _ = flow.shape
            gt = dict(depth_interpolation_mode=self.depth_interpolation_mode,
                      relative_depth_error_threshold=self.relative_depth_error_threshold, H=h, W=w)
            with torch.no_grad():
                x2, prob = get_gt_warp(batch["im_A_depth"], batch["im_B_depth"], batch["T_1to2"],
                                       batch["K1"], batch["K2"], **gt)
            if "corr_volume" in sc:
                with torch.no_grad():
                    t_inv = torch.linalg.inv(batch["T_1to2"].float())
                    x2_back, _ = get_gt_warp(batch["im_B_depth"], batch["im_A_depth"], t_inv,
                                             batch["K2"], batch["K1"], **gt)
                    grid = batched_grid(1, h, w, flow.device)[0].reshape(h * w, 2)
                    mnn = mutual_nearest_mask(x2.reshape(b, h * w, 2), x2_back.reshape(b, h * w, 2), grid)
                cv_loss = self.corr_volume_loss(mnn, sc["corr_volume"])
                metrics[f"gm_corr_volume_loss_{scale}"] = cv_loss
                tot = tot + cv_loss

            reg_loss, ce_loss, pck = self.regression_loss(x2, prob, flow, certainty, scale)
            metrics[f"delta_regression_loss_{scale}"] = reg_loss
            metrics[f"delta_certainty_loss_{scale}"] = ce_loss
            if scale == 1:
                metrics["train_pck_05"] = pck
            tot = tot + self.ce_weight * ce_loss + reg_loss
        metrics["total_loss"] = tot
        return tot, metrics
