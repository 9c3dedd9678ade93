"""Ground-truth warp supervision from depth and pose (counterpart of
roma_tpu/train/gt_warp.py; reference romatch/utils/utils.py:325-454).

Unproject image A's grid with depth A, move it rigidly, project it into B;
a point is valid where its depth is nonzero, it lands inside B, and B's depth
there agrees with the computed depth to ``relative_depth_error_threshold``.
Float32, with the JAX package's formulation: a linear solve instead of the
explicit inverse of K, and an epsilon-guarded division.
"""
from __future__ import annotations

import torch

from ..ops import batched_grid, grid_sample


def warp_kpts(
    kpts0: torch.Tensor,
    depth0: torch.Tensor,
    depth1: torch.Tensor,
    T_0to1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
    depth_interpolation_mode: str = "bilinear",
    relative_depth_error_threshold: float = 0.05,
):
    """Warp normalized kpts0 (B, L, 2) from image 0 to image 1.

    depth0/1: (B, H, W); T_0to1: (B, 4, 4) or (B, 3, 4); K: (B, 3, 3).
    ``depth_interpolation_mode``: "bilinear", "nearest-exact" (or any mode
    naming "nearest"), or "combined", which fills the bilinear misses with
    the nearest hits. Returns (valid (B, L) bool, warped kpts (B, L, 2)).
    """
    if depth_interpolation_mode == "combined":
        args = (kpts0, depth0, depth1, T_0to1, K0, K1)
        valid_b, warp_b = warp_kpts(*args, "bilinear", relative_depth_error_threshold)
        valid_n, warp_n = warp_kpts(*args, "nearest-exact", relative_depth_error_threshold)
        fill = ~valid_b & valid_n
        return valid_b | valid_n, torch.where(fill[..., None], warp_n, warp_b)

    mode = "nearest" if "nearest" in depth_interpolation_mode else "bilinear"
    b, h, w = depth0.shape
    kpts0 = kpts0.float()
    d0 = grid_sample(depth0[..., None].float(), kpts0[:, :, None], mode=mode)[:, :, 0, 0]
    nonzero = d0 != 0

    # normalized -> pixel coords ([-1+1/n, 1-1/n] -> [0.5, n-0.5])
    pix = torch.stack((w * (kpts0[..., 0] + 1) / 2, h * (kpts0[..., 1] + 1) / 2), dim=-1)
    homo = torch.cat((pix, torch.ones_like(pix[..., :1])), dim=-1) * d0[..., None]
    cam0 = torch.linalg.solve(K0.float(), homo.transpose(1, 2))  # (B, 3, L)

    R = T_0to1[:, :3, :3].float()
    t = T_0to1[:, :3, 3:4].float()
    cam1 = R @ cam0 + t
    depth_computed = cam1[:, 2, :]

    proj = (K1.float() @ cam1).transpose(1, 2)  # (B, L, 3)
    xy = proj[..., :2] / (proj[..., 2:3] + 1e-4)

    h1, w1 = depth1.shape[1:3]
    covisible = (xy[..., 0] > 0) & (xy[..., 0] < w1 - 1) & (xy[..., 1] > 0) & (xy[..., 1] < h1 - 1)
    xy_n = torch.stack((2 * xy[..., 0] / w1 - 1, 2 * xy[..., 1] / h1 - 1), dim=-1)

    d1 = grid_sample(depth1[..., None].float(), xy_n[:, :, None], mode=mode)[:, :, 0, 0]
    rel_err = ((d1 - depth_computed) / torch.where(d1 == 0, torch.full_like(d1, 1e-12), d1)).abs()
    consistent = rel_err < relative_depth_error_threshold
    return nonzero & covisible & consistent, xy_n


def get_gt_warp(
    depth1, depth2, T_1to2, K1, K2,
    depth_interpolation_mode: str = "bilinear",
    relative_depth_error_threshold: float = 0.05,
    H: int | None = None,
    W: int | None = None,
):
    """(B, H, W, 2) GT warp and (B, H, W) float validity for supervision at
    resolution (H, W), by default depth1's (reference utils.py:325-353)."""
    b = depth1.shape[0]
    if H is None:
        _, H, W = depth1.shape
    grid = batched_grid(b, H, W, device=depth1.device).reshape(b, H * W, 2)
    mask, x2 = warp_kpts(
        grid, depth1, depth2, T_1to2, K1, K2,
        depth_interpolation_mode=depth_interpolation_mode,
        relative_depth_error_threshold=relative_depth_error_threshold,
    )
    return x2.reshape(b, H, W, 2), mask.float().reshape(b, H, W)
