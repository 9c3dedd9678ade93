"""ScanNet pair dataset (counterpart of roma_tpu/datasets/scannet.py;
reference romatch/datasets/scannet.py:22-160).

Same on-disk layout: ``scannet_indices`` npz scene infos, every-10th frames,
16-bit PNG depths in millimetres, world2cam poses from cam2world txt, colour
intrinsics txt. The depth PNG is read with PIL (the JAX package reads it
with OpenCV; both give the file's uint16 values), so the port needs no
OpenCV.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from . import transforms as T
from .megadepth import ConcatDataset


class ScanNetScene:
    def __init__(
        self,
        data_root,
        scene_info,
        ht=384,
        wt=512,
        min_overlap=0.0,
        use_horizontal_flip_aug=False,
        seed: int = 0,
    ):
        self.scene_root = osp.join(data_root, "scans", "scans_train")
        self.data_names = scene_info["name"]
        self.overlaps = scene_info["score"]
        valid = (self.data_names[:, -2:] % 10).sum(axis=-1) == 0  # every-10th frames
        self.overlaps = self.overlaps[valid]
        self.data_names = self.data_names[valid]
        self.rng = np.random.RandomState(seed)
        if len(self.data_names) > 10000:
            inds = self.rng.choice(len(self.data_names), 10000, replace=False)
            self.data_names = self.data_names[inds]
            self.overlaps = self.overlaps[inds]
        self.ht, self.wt = ht, wt
        self.use_horizontal_flip_aug = use_horizontal_flip_aug

    def __len__(self):
        return len(self.data_names)

    @staticmethod
    def read_pose(path):
        """cam2world txt -> world2cam (reference scannet.py:72-80)."""
        return np.linalg.inv(np.loadtxt(path, delimiter=" ")).astype(np.float32)

    @staticmethod
    def read_intrinsic(path):
        K = np.loadtxt(path, delimiter=" ")
        return K[:-1, :-1].astype(np.float32)

    def _load_depth(self, path):
        from PIL import Image

        with Image.open(path) as im:
            depth = np.asarray(im)
        return (depth / 1000).astype(np.float32)

    def _scale_K(self, K, wi, hi):
        return np.diag([self.wt / wi, self.ht / hi, 1.0]).astype(np.float32) @ K

    def __getitem__(self, pair_idx):
        from PIL import Image

        scene_name, scene_sub_name, stem_1, stem_2 = self.data_names[pair_idx]
        scene_name = f"scene{scene_name:04d}_{scene_sub_name:02d}"
        root = osp.join(self.scene_root, scene_name)
        K = self.read_intrinsic(osp.join(root, "intrinsic", "intrinsic_color.txt"))
        T1 = self.read_pose(osp.join(root, "pose", f"{stem_1}.txt"))
        T2 = self.read_pose(osp.join(root, "pose", f"{stem_2}.txt"))
        T_1to2 = (T2 @ np.linalg.inv(T1)).astype(np.float32)[:4, :4]

        pil_A = Image.open(osp.join(root, "color", f"{stem_1}.jpg"))
        pil_B = Image.open(osp.join(root, "color", f"{stem_2}.jpg"))
        depth_A = T.resize_depth(
            self._load_depth(osp.join(root, "depth", f"{stem_1}.png")), self.ht, self.wt
        )
        depth_B = T.resize_depth(
            self._load_depth(osp.join(root, "depth", f"{stem_2}.png")), self.ht, self.wt
        )
        K1 = self._scale_K(K, pil_A.width, pil_A.height)
        K2 = self._scale_K(K, pil_B.width, pil_B.height)
        im_A = T.normalize_image(T.resize_image(pil_A, self.ht, self.wt))
        im_B = T.normalize_image(T.resize_image(pil_B, self.ht, self.wt))

        if self.use_horizontal_flip_aug and self.rng.rand() > 0.5:
            im_A, im_B, depth_A, depth_B, K1, K2 = T.horizontal_flip_pair(
                im_A, im_B, depth_A, depth_B, K1, K2, self.wt
            )
        return {
            "im_A": im_A,
            "im_B": im_B,
            "im_A_depth": depth_A,
            "im_B_depth": depth_B,
            "K1": K1,
            "K2": K2,
            "T_1to2": T_1to2,
        }


class ScanNetBuilder:
    def __init__(self, data_root="data/scannet"):
        self.data_root = data_root
        self.scene_info_root = os.path.join(data_root, "scannet_indices")
        self.all_scenes = (
            os.listdir(self.scene_info_root) if os.path.isdir(self.scene_info_root) else []
        )

    def build_scenes(self, split="train", min_overlap=0.0, **kwargs):
        scenes = []
        for scene_name in self.all_scenes:
            scene_info = np.load(
                os.path.join(self.scene_info_root, scene_name), allow_pickle=True
            )
            scenes.append(
                ScanNetScene(self.data_root, scene_info, min_overlap=min_overlap, **kwargs)
            )
        return scenes

    def build_concat(self, **kwargs) -> ConcatDataset:
        return ConcatDataset(self.build_scenes(**kwargs))

    @staticmethod
    def weight_scenes(concat: ConcatDataset, alpha=0.5) -> np.ndarray:
        return np.concatenate(
            [np.full(len(d), 1.0 / len(d) ** alpha, np.float32) for d in concat.datasets]
        )
