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


def check_not_i16(im: Image.Image):
    """Refuse a 16-bit integer image (mode I;16), as the reference's
    check_not_i16 does."""
    if im.mode == "I;16":
        raise ValueError("Input images should not be 16-bit (mode I;16)")


def check_rgb(im: Image.Image):
    """Refuse an image that is not RGB."""
    if im.mode != "RGB":
        raise ValueError(f"Expected an RGB image, got mode {im.mode}")


def to_pil(x: np.ndarray, unnormalize: bool = False) -> Image.Image:
    """float HWC array (optionally ImageNet-normalized) -> PIL image
    (roma_tpu/utils/image.py:to_pil; reference tensor_to_pil, utils.py:460-480)."""
    x = np.asarray(x, np.float32)
    if unnormalize:
        x = x * IMAGENET_STD + IMAGENET_MEAN
    x = np.clip(x, 0.0, 1.0)
    return Image.fromarray((x * 255).astype(np.uint8))


def prepare(im, size_hw: tuple[int, int] | None = None, normalize: bool = True):
    """The whole host preprocess: load, resize to (h, w) when given, [0, 1]
    float32, ImageNet-normalize when asked. Returns the (H, W, 3) array and
    the original (H, W)."""
    pil = load_image(im)
    w0, h0 = pil.size
    if size_hw is not None:
        pil = resize(pil, size_hw)
    x = to_array(pil)
    if normalize:
        x = imagenet_normalize(x)
    return x, (h0, w0)
