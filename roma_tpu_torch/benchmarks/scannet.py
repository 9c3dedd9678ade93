"""ScanNet-1500 pose benchmark (counterpart of
roma_tpu/benchmarks/scannet.py): pair loading from the published test.npz,
then the shared engine of ``pose_bench``. Protocol (reference
romatch/benchmarks/scannet_benchmark.py:9-143): intrinsics rescaled so the
shorter side is 480 px, the 0.5 px pixel-centre offset, 5 RANSAC repeats
with the final one counted twice (a reference quirk, kept for comparable
numbers), AUC@5/10/20 + mAP. The pair order is shuffled by a seeded
generator instead of global NumPy state.
"""
from __future__ import annotations

import os.path as osp

import numpy as np
from PIL import Image

from .pose_bench import PosePair, cv2_estimator, run_pose_benchmark

PROTOCOL_SHORT_SIDE = 480


def load_scannet_pairs(data_root: str, shuffle_seed: int = 0) -> list[PosePair]:
    """test.npz -> PosePairs (intrinsics from each scene's
    intrinsic_color.txt, rescaled to a 480 px short side)."""
    data = np.load(osp.join(data_root, "test.npz"))
    names, rel_poses = data["name"], data["rel_pose"]
    order = np.random.default_rng(shuffle_seed).permutation(len(names))
    intrinsics_cache: dict[str, np.ndarray] = {}
    pairs: list[PosePair] = []
    for i in order:
        scene = names[i]
        scene_name = f"scene0{scene[0]}_00"
        scene_dir = osp.join(data_root, "scans_test", scene_name)
        path_A = osp.join(scene_dir, "color", f"{scene[2]}.jpg")
        path_B = osp.join(scene_dir, "color", f"{scene[3]}.jpg")
        if scene_name not in intrinsics_cache:
            intrinsics_cache[scene_name] = np.loadtxt(osp.join(scene_dir, "intrinsic", "intrinsic_color.txt"))
        K = intrinsics_cache[scene_name]
        T_gt = rel_poses[i].reshape(3, 4)
        with Image.open(path_A) as im:
            w1, h1 = im.size
        with Image.open(path_B) as im:
            w2, h2 = im.size
        s1 = PROTOCOL_SHORT_SIDE / min(w1, h1)
        s2 = PROTOCOL_SHORT_SIDE / min(w2, h2)
        pairs.append(PosePair(im_A=path_A, im_B=path_B, K1=K.copy() * s1, K2=K.copy() * s2,
                              R=T_gt[:3, :3], t=T_gt[:3, 3], hw_A=(s1 * h1, s1 * w1), hw_B=(s2 * h2, s2 * w2)))
    return pairs


class ScanNetBenchmark:
    def __init__(self, data_root="data/scannet", seed: int = 0):
        self.data_root = data_root
        self.seed = seed

    def benchmark(self, model, model_name=None, batch_size: int | None = None):
        pairs = load_scannet_pairs(self.data_root, shuffle_seed=self.seed)
        return run_pose_benchmark(model, pairs, estimator=cv2_estimator, repeats=5,
                                  pixel_offset=0.5,  # ScanNet's pixel-centre convention
                                  double_final_repeat=True, batch_size=batch_size, seed=self.seed)
