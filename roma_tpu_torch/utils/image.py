"""Image IO and preprocessing (counterpart of roma_tpu/utils/image.py):
load to RGB and bicubic resize on the host with PIL; ImageNet normalization
of a NumPy array or of a tensor on any device.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image(im) -> Image.Image:
    """str/Path/PIL/HWC array -> RGB PIL image. Float arrays are taken as
    [0, 1]; arrays may be (H, W) or (H, W, 1|3|4)."""
    if isinstance(im, (str, Path)):
        im = Image.open(im)
    elif isinstance(im, np.ndarray):
        x = im
        if x.ndim not in (2, 3) or (x.ndim == 3 and x.shape[-1] not in (1, 3, 4)):
            raise ValueError(f"expected (H, W[, 1|3|4]) image array, got {x.shape}")
        if np.issubdtype(x.dtype, np.floating):
            x = (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)
        if x.ndim == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        im = Image.fromarray(x)
    if not isinstance(im, Image.Image):
        raise TypeError(f"expected path, PIL image, or array, got {type(im)}")
    return im.convert("RGB")


def to_array(im: Image.Image) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1] (torchvision ToTensor semantics)."""
    return np.asarray(im, dtype=np.float32) / 255.0


def resize(im: Image.Image, size_hw: tuple[int, int], mode=Image.BICUBIC) -> Image.Image:
    """Resize to (h, w) with bicubic filtering, as the reference's TupleResize."""
    h, w = size_hw
    return im.resize((w, h), mode)


def imagenet_normalize(x):
    """(x - mean) / std over the last axis; x a float NumPy array or tensor
    in [0, 1], HWC or NHWC."""
    if isinstance(x, np.ndarray):
        return (x - IMAGENET_MEAN) / IMAGENET_STD
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x - mean) / std
