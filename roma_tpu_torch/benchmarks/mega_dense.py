"""MegaDepth dense-warp benchmark (counterpart of
roma_tpu/benchmarks/mega_dense.py; reference
romatch/benchmarks/megadepth_dense_benchmark.py:9-105): EPE and PCK@1/3/5 px
of the predicted warp against the ground-truth depth reprojection.

The batch goes to the matcher's device, the geometric distance runs there
through the port's ``train.gt_warp.warp_kpts``, and the ragged tail of the
sampled pairs is dropped, as the JAX benchmark drops it.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..datasets.loader import BATCH_KEYS, to_device
from ..train.gt_warp import warp_kpts


def _pixels(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[-1, 1] (x, y) -> pixel coordinates at (h, w)."""
    return torch.stack((w * (x[..., 0] + 1) / 2, h * (x[..., 1] + 1) / 2), dim=-1)


def _geometric_dist(depth1, depth2, T_1to2, K1, K2, dense_matches, h1: int, w1: int):
    """EPE over the pixels whose GT warp is valid, and the share of them
    within 1, 3 and 5 px; ``dense_matches`` (B, h1, w1, 4) is the warp
    (x_A, y_A, x_B, y_B) in [-1, 1]. Four 0-d tensors."""
    b = dense_matches.shape[0]
    x1 = dense_matches[..., :2].reshape(b, h1 * w1, 2)
    mask, x2 = warp_kpts(x1, depth1, depth2, T_1to2, K1, K2)
    x2 = _pixels(x2, h1, w1)
    prob = mask.float().reshape(b, h1, w1)
    x2_hat = _pixels(dense_matches[..., 2:], h1, w1)
    gd = torch.linalg.vector_norm(x2_hat - x2.reshape(b, h1, w1, 2), dim=-1)
    valid = prob == 1
    n = valid.sum().clamp(min=1)
    gd_mean = (gd * valid).sum() / n
    pck = lambda t: ((gd < t) * valid).sum() / n
    return gd_mean, pck(1.0), pck(3.0), pck(5.0)


class MegadepthDenseBenchmark:
    def __init__(self, data_root="data/megadepth", h=384, w=512, num_samples=2000,
                 dataset=None, seed=0):
        """``dataset``: any pair dataset with the training items' keys (e.g.
        a ScanNet concat); else MegaDepth's ``test_loftr`` scenes at (h, w)."""
        if dataset is None:
            from ..datasets.megadepth import MegadepthBuilder

            mega = MegadepthBuilder(data_root=data_root)
            dataset = mega.build_concat(split="test_loftr", ht=h, wt=w)
        self.dataset = dataset
        self.num_samples = num_samples
        self.h, self.w = h, w
        self.rng = np.random.RandomState(seed)

    def _dump_debug(self, debug_dir, batch_idx, batch, matches, certainty):
        """Certainty-blended warp visualizations, one directory a pair (the
        reference's DEBUG_MODE dumps, megadepth_dense_benchmark.py:71-91)."""
        from ..ops import grid_sample
        from ..utils.image import to_pil

        b, h1, w1 = certainty.shape[0], matches.shape[1], matches.shape[2]
        im_B = batch["im_B"].to(matches.device, torch.float32)
        warp_rgb = grid_sample(im_B, matches[..., 2:].float()).cpu().numpy()  # (B, H, W, 3)
        c = certainty.float().cpu().numpy()[..., None]
        vis = c * warp_rgb + (1 - c) * np.ones_like(warp_rgb)
        for i in range(b):
            d = os.path.join(debug_dir, f"{batch_idx}_{i}_{h1}_{w1}")
            os.makedirs(d, exist_ok=True)
            to_pil(vis[i], unnormalize=True).save(os.path.join(d, "warp.jpg"))
            to_pil(batch["im_A"][i].cpu().numpy(), unnormalize=True).save(os.path.join(d, "im_A.jpg"))
            to_pil(batch["im_B"][i].cpu().numpy(), unnormalize=True).save(os.path.join(d, "im_B.jpg"))

    def benchmark(self, model, batch_size=8, debug_dir=None):
        """Mean EPE and PCK@1/3/5 over the sampled pairs' batches; ``model``
        has ``match(im_A, im_B, batched=True)``, ``symmetric`` and ``device``."""
        from tqdm import tqdm

        idxs = self.rng.choice(
            len(self.dataset), size=min(self.num_samples, len(self.dataset)), replace=False
        )
        gd_tot = pck1_tot = pck3_tot = pck5_tot = 0.0
        num_batches = 0
        for start in tqdm(range(0, len(idxs), batch_size)):
            chunk = idxs[start : start + batch_size]
            if len(chunk) < batch_size:
                break  # the ragged tail is dropped, as the JAX benchmark drops it
            items = [self.dataset[i] for i in chunk]
            batch = to_device({k: np.stack([it[k] for it in items]) for k in BATCH_KEYS}, model.device)
            matches, certainty = model.match(batch["im_A"], batch["im_B"], batched=True)
            if model.symmetric:
                matches = matches[:, :, : matches.shape[2] // 2]
                certainty = certainty[:, :, : matches.shape[2]]
            h1, w1 = matches.shape[1], matches.shape[2]
            if debug_dir is not None:
                self._dump_debug(debug_dir, num_batches, batch, matches, certainty)
            gd, pck1, pck3, pck5 = _geometric_dist(
                batch["im_A_depth"], batch["im_B_depth"], batch["T_1to2"],
                batch["K1"], batch["K2"], matches.float(), h1=h1, w1=w1,
            )
            gd_tot += float(gd)
            pck1_tot += float(pck1)
            pck3_tot += float(pck3)
            pck5_tot += float(pck5)
            num_batches += 1
        n = max(num_batches, 1)
        return {
            "epe": gd_tot / n,
            "mega_pck_1": pck1_tot / n,
            "mega_pck_3": pck3_tot / n,
            "mega_pck_5": pck5_tot / n,
        }
