"""Plain float32 training step of RoMa: ground-truth warp from depth and
pose, the robust multi-scale losses, and a global-norm clip followed by
two-group AdamW. A frozen copy of what roma_tpu_torch's recipe step
computes, over :class:`~.roma.RoMaReference` in training mode, without
autocast, without recompute and without any kernel.
"""
from __future__ import annotations

import math

import torch

from .roma import RoMaReference, grid_sample, normalized_grid, resize


def warp_kpts(kpts0, depth0, depth1, T_0to1, K0, K1, rel_thresh=0.05):
    """Normalized kpts0 (B, L, 2) of image 0 warped into image 1 by depth and
    pose (bilinear depth lookups): (valid (B, L) bool, (B, L, 2))."""
    b, h, w = depth0.shape
    d0 = grid_sample(depth0[..., None], kpts0[:, :, None])[:, :, 0, 0]
    pix = torch.stack((w * (kpts0[..., 0] + 1) / 2, h * (kpts0[..., 1] + 1) / 2), dim=-1)
    homo = torch.cat((pix, torch.ones_like(pix[..., :1])), dim=-1) * d0[..., None]
    cam0 = torch.linalg.solve(K0, homo.transpose(1, 2))
    cam1 = T_0to1[:, :3, :3] @ cam0 + T_0to1[:, :3, 3:4]
    proj = (K1 @ cam1).transpose(1, 2)
    xy = proj[..., :2] / (proj[..., 2:3] + 1e-4)
    h1, w1 = depth1.shape[1:3]
    covisible = (xy[..., 0] > 0) & (xy[..., 0] < w1 - 1) & (xy[..., 1] > 0) & (xy[..., 1] < h1 - 1)
    xy_n = torch.stack((2 * xy[..., 0] / w1 - 1, 2 * xy[..., 1] / h1 - 1), dim=-1)
    d1 = grid_sample(depth1[..., None], xy_n[:, :, None])[:, :, 0, 0]
    rel = ((d1 - cam1[:, 2, :]) / torch.where(d1 == 0, torch.full_like(d1, 1e-12), d1)).abs()
    return (d0 != 0) & covisible & (rel < rel_thresh), xy_n


def gt_warp(batch, h, w):
    """(B, h, w, 2) ground-truth warp of A into B and its (B, h, w) validity."""
    b = batch["im_A_depth"].shape[0]
    grid = normalized_grid(h, w, batch["im_A_depth"].device).expand(b, h, w, 2).reshape(b, h * w, 2)
    valid, x2 = warp_kpts(grid, batch["im_A_depth"], batch["im_B_depth"], batch["T_1to2"], batch["K1"], batch["K2"])
    return x2.reshape(b, h, w, 2), valid.float().reshape(b, h, w)


def masked_mean(x, mask):
    m = mask.float()
    total = m.sum()
    return torch.where(total > 0, (x * m).sum() / total.clamp(min=1.0), torch.zeros_like(total))


def bce_with_logits(z, t):
    return (z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()


def robust_loss(corresps, batch, ce_weight=0.01, local_dist=None, local_largest_scale=8, alpha=0.5, c=1e-4):
    """The recipe's loss, coarse to fine: anchor cross-entropy and certainty
    BCE at scale 16, generalized Charbonnier regression on the EPE and
    certainty BCE at every scale, supervision gated off where the coarser
    scale's EPE exceeded 2/512 * local_dist[s] * s."""
    local_dist = local_dist or {1: 4.0, 2: 4.0, 4: 8.0, 8: 8.0}
    tot, prev_epe = 0.0, None
    for s in sorted(corresps, reverse=True):
        sc = corresps[s]
        flow, cert = sc["flow"], sc["certainty"]
        h, w = flow.shape[1:3]
        with torch.no_grad():
            x2, prob = gt_warp(batch, h, w)
            if local_largest_scale >= s and prev_epe is not None:
                near = resize(prev_epe[..., None], (h, w), mode="nearest-exact")[..., 0]
                prob = prob * (near < (2 / 512) * (local_dist[s] * s)).float()
        if "gm_cls" in sc:
            cls = sc["gm_cls"]
            n = cls.shape[-1]
            res = round(math.sqrt(n))
            anchors = normalized_grid(res, res, cls.device).reshape(n, 2)
            gt = ((anchors - x2[..., None, :]) ** 2).sum(-1).argmin(-1)
            ce = -torch.log_softmax(cls, dim=-1).gather(-1, gt[..., None])[..., 0]
            tot = tot + ce_weight * bce_with_logits(sc["gm_certainty"][..., 0], prob) + masked_mean(ce, prob > 0.99)
        epe = (flow - x2).norm(dim=-1)
        cs = c * s
        reg = cs ** alpha * ((epe / cs) ** 2 + 1.0) ** (alpha / 2)
        tot = tot + ce_weight * bce_with_logits(cert[..., 0], prob) + masked_mean(reg, prob > 0.99)
        prev_epe = epe.detach()
    return tot


class AdamW:
    """Global-norm clip of every trainable gradient to ``clip``, then AdamW
    (betas 0.9, 0.999, eps 1e-8, decoupled decay) with one rate a group."""

    def __init__(self, params: dict[str, torch.Tensor], lr_of, weight_decay=0.01, clip=0.01):
        self.params, self.lr_of, self.wd, self.clip = params, lr_of, weight_decay, clip
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor | None]) -> dict[str, torch.Tensor]:
        """One update; returns the gradients as the update saw them (clipped)."""
        live = {k: g for k, g in grads.items() if g is not None}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in live.values()]))
        scale = self.clip / torch.maximum(norm, torch.full_like(norm, self.clip))
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        seen = {}
        for k, g in live.items():
            g = g * scale
            seen[k] = g
            p, m, v, lr = self.params[k], self.m[k], self.v[k], self.lr_of(k)
            p.mul_(1 - lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)).add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** self.t))
        return seen


def train_steps(cfg: dict, weights: dict[str, torch.Tensor], batches, trainable, lr_of, loss_kw: dict,
                on_step=None, fp8: bool = False, keep_first: dict | None = None, gm_logit_bias=None):
    """Run one training step a batch from ``weights`` (updated in place);
    ``cfg`` is the configuration file's object (its "model" and
    "optimizer"); ``trainable(name)`` picks the parameters; ``on_step(i,
    loss, grads)`` sees each step's float32 loss and clipped gradients;
    ``fp8`` computes every product from float8 operands; ``keep_first``
    receives the first step's DINOv2 readings (``RoMaReference.forward``'s
    ``keep``); ``gm_logit_bias`` is added to the coarse anchor logits.
    Returns the losses."""
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    params = {k: weights[k].requires_grad_(True) for k in weights if trainable(k) and not k.endswith(buffers)}
    opt = AdamW(params, lr_of, cfg["optimizer"]["weight_decay"], cfg["optimizer"]["grad_clip"])
    net = RoMaReference(cfg["model"], weights, train=True, fp8=fp8)
    losses = []
    for i, batch in enumerate(batches):
        keep = keep_first if i == 0 else None
        loss = robust_loss(net.forward(batch["im_A"], batch["im_B"], keep=keep, gm_logit_bias=gm_logit_bias), batch,
                           **loss_kw)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        seen = opt.step(dict(zip(params, grads)))
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(i, losses[-1], seen)
    for p in params.values():
        p.requires_grad_(False)
    return losses
