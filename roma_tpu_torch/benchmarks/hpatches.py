"""HPatches homography benchmark (counterpart of
roma_tpu/benchmarks/hpatches.py). Protocol (reference
romatch/benchmarks/hpatches_sequences_homog_benchmark.py:11-113): per
sequence, image 1 against images 2..6, a homography from 5000 sampled
matches by OpenCV RANSAC (reprojection threshold 3 px at a 480 px short
side), scored by the mean corner-warp error normalized to the 480 px scale,
AUC over thresholds 1..10. HPatches puts the top-left pixel centre at
(0, 0), hence ``PIXEL_OFFSET``. OpenCV and tqdm are imported inside
``benchmark``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
from PIL import Image

from .pose import pose_auc
from .pose_bench import to_host

IGNORE_SEQS = {
    "i_contruction",
    "i_crownnight",
    "i_dc",
    "i_pencils",
    "i_whitebuilding",
    "v_artisans",
    "v_astronautis",
    "v_talent",
}

PIXEL_OFFSET = 0.5
NORM_SHORT_SIDE = 480.0


@dataclasses.dataclass
class HomogPair:
    im_A: str
    im_B: str
    H_gt: np.ndarray
    wh_A: tuple[int, int]
    wh_B: tuple[int, int]


def load_hpatches_pairs(seqs_path: str) -> list[HomogPair]:
    pairs: list[HomogPair] = []
    for seq_name in sorted(os.listdir(seqs_path)):
        if seq_name in IGNORE_SEQS:
            continue
        seq_dir = os.path.join(seqs_path, seq_name)
        path_A = os.path.join(seq_dir, "1.ppm")
        with Image.open(path_A) as im:
            wh_A = im.size
        for idx in range(2, 7):
            path_B = os.path.join(seq_dir, f"{idx}.ppm")
            with Image.open(path_B) as im:
                wh_B = im.size
            H_gt = np.loadtxt(os.path.join(seq_dir, f"H_1_{idx}"))
            pairs.append(HomogPair(path_A, path_B, H_gt, wh_A, wh_B))
    return pairs


def corner_warp_error(H_est: np.ndarray, pair: HomogPair) -> float:
    """Mean distance between the GT and estimated homographies' corner
    warps, normalized to the 480 px short-side scale."""
    w1, h1 = pair.wh_A
    corners = np.array([[0, 0, 1], [0, h1 - 1, 1], [w1 - 1, 0, 1], [w1 - 1, h1 - 1, 1]], np.float64)
    gt = corners @ pair.H_gt.T
    est = corners @ H_est.T
    gt = gt[:, :2] / gt[:, 2:]
    est = est[:, :2] / est[:, 2:]
    scale = min(pair.wh_B) / NORM_SHORT_SIDE
    return float(np.mean(np.linalg.norm(gt - est, axis=1)) / scale)


class HpatchesHomogBenchmark:
    def __init__(self, dataset_path):
        self.seqs_path = os.path.join(dataset_path, "hpatches-sequences-release")

    def _to_pixels(self, coords, wh) -> np.ndarray:
        w, h = wh
        return np.stack((w * (coords[..., 0] + 1) / 2, h * (coords[..., 1] + 1) / 2), axis=-1) - PIXEL_OFFSET

    def benchmark(self, model, model_name=None, sample_n: int = 5000):
        import cv2
        from tqdm import tqdm

        pairs = load_hpatches_pairs(self.seqs_path)
        dists = []
        for pair in tqdm(pairs):
            warp, certainty = model.match(pair.im_A, pair.im_B)
            matches, _ = model.sample(warp, certainty, sample_n)
            matches = to_host(matches)
            pos_A = self._to_pixels(matches[:, :2], pair.wh_A)
            pos_B = self._to_pixels(matches[:, 2:], pair.wh_B)
            try:
                H_est, _ = cv2.findHomography(pos_A, pos_B, method=cv2.RANSAC, confidence=0.99999,
                                              ransacReprojThreshold=3 * min(pair.wh_B) / NORM_SHORT_SIDE)
            except Exception:
                H_est = None
            if H_est is None:
                H_est = np.diag([0.0, 0.0, 1.0])  # degenerate -> a large error
            dists.append(corner_warp_error(H_est, pair))
        auc = pose_auc(np.asarray(dists), list(range(1, 11)))
        return {
            "hpatches_homog_auc_3": auc[2],
            "hpatches_homog_auc_5": auc[4],
            "hpatches_homog_auc_10": auc[9],
        }
