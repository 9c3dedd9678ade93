"""MegaDepth pair dataset (counterpart of roma_tpu/datasets/megadepth.py;
reference romatch/datasets/megadepth.py:13-232).

Host-side NumPy, PIL and h5py (imported by the depth read alone, so the
package imports without it); the same precomputed ``prep_scene_info/*.npy``
scene files (image and depth paths, intrinsics, poses, pairs, overlaps).
Items are dicts of float32 arrays (NHWC images, HW depths); each scene draws
its augmentations from its own seeded ``RandomState`` in the JAX package's
order, so a seed gives the same items.
"""
from __future__ import annotations

import math
import os

import numpy as np

from . import transforms as T


class MegadepthScene:
    def __init__(
        self,
        data_root,
        scene_info,
        ht=384,
        wt=512,
        min_overlap=0.0,
        max_overlap=1.0,
        shake_t=0,
        normalize=True,
        max_num_pairs=100_000,
        scene_name=None,
        use_horizontal_flip_aug=False,
        random_eraser: T.RandomErasing | None = None,
        colorjiggle: T.ColorJiggle | None = None,
        use_randaug=False,
        randaug_params: dict | None = None,
        randomize_size=False,
        rank: int = 0,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.scene_name = (
            os.path.splitext(scene_name)[0] + f"_{min_overlap}_{max_overlap}"
            if scene_name
            else None
        )
        self.image_paths = scene_info["image_paths"]
        self.depth_paths = scene_info["depth_paths"]
        self.intrinsics = scene_info["intrinsics"]
        self.poses = scene_info["poses"]
        pairs = scene_info["pairs"]
        overlaps = scene_info["overlaps"]
        keep = (overlaps > min_overlap) & (overlaps < max_overlap)
        self.pairs = pairs[keep]
        self.overlaps = overlaps[keep]
        self.rng = np.random.RandomState(seed)
        if len(self.pairs) > max_num_pairs:
            inds = self.rng.choice(len(self.pairs), max_num_pairs, replace=False)
            self.pairs = self.pairs[inds]
            self.overlaps = self.overlaps[inds]
        if randomize_size:
            # per-rank aspect choice (reference megadepth.py:52-57)
            area = ht * wt
            s = int(16 * (math.sqrt(area) // 16))
            sizes = ((ht, wt), (s, s), (wt, ht))
            ht, wt = sizes[rank % 3]
        self.ht, self.wt = ht, wt
        self.normalize = normalize
        self.shake_t = shake_t
        self.use_horizontal_flip_aug = use_horizontal_flip_aug
        self.random_eraser = random_eraser
        self.colorjiggle = colorjiggle
        self.use_randaug = use_randaug
        self.randaug_params = randaug_params or {}

    def __len__(self):
        return len(self.pairs)

    def _load_depth(self, path):
        import h5py

        with h5py.File(path, "r") as f:
            return np.asarray(f["depth"], np.float32)

    def _scale_K(self, K, wi, hi):
        s = np.diag([self.wt / wi, self.ht / hi, 1.0]).astype(np.float32)
        return s @ np.asarray(K, np.float32).reshape(3, 3)

    def __getitem__(self, pair_idx):
        from PIL import Image

        idx1, idx2 = self.pairs[pair_idx]
        T1 = self.poses[idx1]
        T2 = self.poses[idx2]
        T_1to2 = (T2 @ np.linalg.inv(T1)).astype(np.float32)[:4, :4]

        im_A_ref = os.path.join(self.data_root, self.image_paths[idx1])
        im_B_ref = os.path.join(self.data_root, self.image_paths[idx2])
        pil_A = Image.open(im_A_ref)
        pil_B = Image.open(im_B_ref)
        K1 = self._scale_K(self.intrinsics[idx1], pil_A.width, pil_A.height)
        K2 = self._scale_K(self.intrinsics[idx2], pil_B.width, pil_B.height)

        if self.use_randaug:
            # reference hook point megadepth.py:133-134
            pil_A, pil_B = T.rand_augment_pair(self.rng, pil_A, pil_B, **self.randaug_params)

        im_A = T.resize_image(pil_A, self.ht, self.wt)
        im_B = T.resize_image(pil_B, self.ht, self.wt)
        if self.colorjiggle is not None:
            # pre-normalize, matching the transform-pipeline position the
            # reference intended (utils.py:164-173)
            im_A = self.colorjiggle(self.rng, im_A)
            im_B = self.colorjiggle(self.rng, im_B)
        depth_A = T.resize_depth(
            self._load_depth(os.path.join(self.data_root, self.depth_paths[idx1])),
            self.ht, self.wt,
        )
        depth_B = T.resize_depth(
            self._load_depth(os.path.join(self.data_root, self.depth_paths[idx2])),
            self.ht, self.wt,
        )
        if self.normalize:
            im_A = T.normalize_image(im_A)
            im_B = T.normalize_image(im_B)

        if self.shake_t > 0:
            tx, ty = self.rng.choice(range(-self.shake_t, self.shake_t + 1), size=2)
            im_A, im_B = T.translate(im_A, tx, ty), T.translate(im_B, tx, ty)
            depth_A, depth_B = T.translate(depth_A, tx, ty), T.translate(depth_B, tx, ty)
            K1[:2, 2] += (tx, ty)
            K2[:2, 2] += (tx, ty)

        if self.random_eraser is not None:
            im_A, depth_A = self.random_eraser(self.rng, im_A, depth_A)
            im_B, depth_B = self.random_eraser(self.rng, im_B, depth_B)

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
            "im_A_path": im_A_ref,
            "im_B_path": im_B_ref,
            "im_A_identifier": os.path.basename(self.image_paths[idx1]).split(".jpg")[0],
            "im_B_identifier": os.path.basename(self.image_paths[idx2]).split(".jpg")[0],
        }


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[d][idx - self._offsets[d]]


class MegadepthBuilder:
    """Scene enumeration + splits (reference megadepth.py:183-232)."""

    TEST_SCENES = ["0017.npy", "0004.npy", "0048.npy", "0013.npy"]
    TEST_SCENES_LOFTR = ["0015.npy", "0022.npy"]
    LOFTR_IGNORE = {
        "0121.npy", "0133.npy", "0168.npy", "0178.npy", "0229.npy", "0349.npy",
        "0412.npy", "0430.npy", "0443.npy", "1001.npy", "5014.npy", "5015.npy",
        "5016.npy",
    }
    IMC21_SCENES = {
        "0008.npy", "0019.npy", "0021.npy", "0024.npy", "0025.npy", "0032.npy",
        "0063.npy", "1589.npy",
    }

    def __init__(self, data_root="data/megadepth", loftr_ignore=True, imc21_ignore=True):
        self.data_root = data_root
        self.scene_info_root = os.path.join(data_root, "prep_scene_info")
        self.all_scenes = (
            os.listdir(self.scene_info_root) if os.path.isdir(self.scene_info_root) else []
        )
        self.loftr_ignore = loftr_ignore
        self.imc21_ignore = imc21_ignore

    def build_scenes(self, split="train", min_overlap=0.0, scene_names=None, **kwargs):
        if split == "train":
            scene_names = set(self.all_scenes) - set(self.TEST_SCENES)
        elif split == "train_loftr":
            scene_names = set(self.all_scenes) - set(self.TEST_SCENES_LOFTR)
        elif split == "test":
            scene_names = self.TEST_SCENES
        elif split == "test_loftr":
            scene_names = self.TEST_SCENES_LOFTR
        elif split == "custom":
            scene_names = scene_names
        else:
            raise ValueError(f"Split {split} not available")
        scenes = []
        for scene_name in scene_names:
            if self.loftr_ignore and scene_name in self.LOFTR_IGNORE:
                continue
            if self.imc21_ignore and scene_name in self.IMC21_SCENES:
                continue
            if ".npy" not in scene_name:
                continue
            scene_info = np.load(
                os.path.join(self.scene_info_root, scene_name), allow_pickle=True
            ).item()
            scenes.append(
                MegadepthScene(
                    self.data_root, scene_info, min_overlap=min_overlap,
                    scene_name=scene_name, **kwargs,
                )
            )
        return scenes

    def build_concat(self, **kwargs) -> ConcatDataset:
        return ConcatDataset(self.build_scenes(**kwargs))

    @staticmethod
    def weight_scenes(concat: ConcatDataset, alpha=0.5) -> np.ndarray:
        """Per-sample 1/n^alpha weights for weighted sampling."""
        return np.concatenate(
            [np.full(len(d), 1.0 / len(d) ** alpha, np.float32) for d in concat.datasets]
        )
