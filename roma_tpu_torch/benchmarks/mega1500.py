"""MegaDepth-1500 / Mega-8-scenes pose benchmark (counterpart of
roma_tpu/benchmarks/mega1500.py): pair loading from the published scene
.npz files, then the shared engine of ``pose_bench``. Protocol (reference
romatch/benchmarks/megadepth_pose_estimation_benchmark.py:25-116):
intrinsics rescaled so the longer side is 1200 px, 5 RANSAC repeats of 5000
sampled matches, OpenCV 5-point essential estimation, AUC@5/10/20 + mAP.
``benchmark(model, batch_size=N)`` matches through ``serving.MatchEngine``.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .pose import compute_relative_pose
from .pose_bench import PosePair, cv2_estimator, run_pose_benchmark

MEGA_1500_SCENES = [
    "0015_0.1_0.3.npz",
    "0015_0.3_0.5.npz",
    "0022_0.1_0.3.npz",
    "0022_0.3_0.5.npz",
    "0022_0.5_0.7.npz",
]

MEGA_8_SCENES = [
    "mega_8_scenes_0008_0.1_0.3.npz",
    "mega_8_scenes_0008_0.3_0.5.npz",
    "mega_8_scenes_0019_0.1_0.3.npz",
    "mega_8_scenes_0019_0.3_0.5.npz",
    "mega_8_scenes_0021_0.1_0.3.npz",
    "mega_8_scenes_0021_0.3_0.5.npz",
    "mega_8_scenes_0024_0.1_0.3.npz",
    "mega_8_scenes_0024_0.3_0.5.npz",
    "mega_8_scenes_0025_0.1_0.3.npz",
    "mega_8_scenes_0025_0.3_0.5.npz",
    "mega_8_scenes_0032_0.1_0.3.npz",
    "mega_8_scenes_0032_0.3_0.5.npz",
    "mega_8_scenes_1589_0.1_0.3.npz",
    "mega_8_scenes_1589_0.3_0.5.npz",
    "mega_8_scenes_0063_0.1_0.3.npz",
    "mega_8_scenes_0063_0.3_0.5.npz",
]

# DKM/RoMa convention: intrinsics rescaled to a 1200 px long side
PROTOCOL_LONG_SIDE = 1200


def load_megadepth_pairs(data_root: str, scene_names: list[str], test_every: int = 1) -> list[PosePair]:
    """Scene .npz files -> PosePairs with protocol-rescaled geometry."""
    out: list[PosePair] = []
    for scene_name in scene_names:
        scene = np.load(os.path.join(data_root, scene_name), allow_pickle=True)
        intrinsics, poses, im_paths = scene["intrinsics"], scene["poses"], scene["image_paths"]
        for pair_info in scene["pair_infos"][::test_every]:
            idx1, idx2 = pair_info[0]
            T1, T2 = poses[idx1], poses[idx2]
            R, t = compute_relative_pose(T1[:3, :3], T1[:3, 3], T2[:3, :3], T2[:3, 3])
            path_A = os.path.join(data_root, im_paths[idx1])
            path_B = os.path.join(data_root, im_paths[idx2])
            with Image.open(path_A) as im:
                w1, h1 = im.size
            with Image.open(path_B) as im:
                w2, h2 = im.size
            s1 = PROTOCOL_LONG_SIDE / max(w1, h1)
            s2 = PROTOCOL_LONG_SIDE / max(w2, h2)
            K1 = np.asarray(intrinsics[idx1], np.float64).copy()
            K2 = np.asarray(intrinsics[idx2], np.float64).copy()
            K1[:2] *= s1
            K2[:2] *= s2
            out.append(PosePair(im_A=path_A, im_B=path_B, K1=K1, K2=K2, R=R, t=t,
                                hw_A=(s1 * h1, s1 * w1), hw_B=(s2 * h2, s2 * w2)))
    return out


class MegaDepthPoseEstimationBenchmark:
    def __init__(self, data_root="data/megadepth", scene_names=None):
        self.data_root = data_root
        self.scene_names = scene_names or MEGA_1500_SCENES

    def benchmark(self, model, model_name=None, num_ransac_runs: int = 5, batch_size: int | None = None,
                  seed: int = 0):
        pairs = load_megadepth_pairs(self.data_root, self.scene_names)
        return run_pose_benchmark(model, pairs, estimator=cv2_estimator, repeats=num_ransac_runs,
                                  batch_size=batch_size, seed=seed)
