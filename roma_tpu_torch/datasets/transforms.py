"""Host-side pair transforms in NumPy and PIL (counterpart of
roma_tpu/datasets/transforms.py; reference romatch/utils/utils.py tuple
transforms :150-281 and romatch/utils/transforms.py augmentations).

Images flow as float32 HWC in [0, 1], normalized at the end; depths as
float32 HW. Every random draw is an explicit ``np.random.RandomState`` call in
the JAX package's order, so a seed gives its arrays bit for bit.
"""
from __future__ import annotations

import numpy as np
from PIL import Image

from ..utils.image import IMAGENET_MEAN, IMAGENET_STD


def resize_image(im: Image.Image, ht: int, wt: int) -> np.ndarray:
    """Bicubic PIL resize -> float HWC [0,1] (TupleResize default mode)."""
    return np.asarray(im.convert("RGB").resize((wt, ht), Image.BICUBIC), np.float32) / 255.0


def resize_depth(depth: np.ndarray, ht: int, wt: int, mode: str = "bilinear") -> np.ndarray:
    """Depth resize; 'bilinear' (TupleResize BILINEAR) or 'nearest-exact'."""
    h, w = depth.shape
    if (h, w) == (ht, wt):
        return depth.astype(np.float32)
    if mode == "nearest-exact":
        ys = np.clip(((np.arange(ht) + 0.5) * h / ht).astype(np.int64), 0, h - 1)
        xs = np.clip(((np.arange(wt) + 0.5) * w / wt).astype(np.int64), 0, w - 1)
        return depth[ys[:, None], xs[None, :]].astype(np.float32)
    # separable bilinear with torch align_corners=False semantics
    def axis_weights(n_in, n_out):
        src = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
        x0 = np.floor(src)
        f = src - x0
        i0 = np.clip(x0, 0, n_in - 1).astype(np.int64)
        i1 = np.clip(x0 + 1, 0, n_in - 1).astype(np.int64)
        return i0, i1, f.astype(np.float32)

    y0, y1, fy = axis_weights(h, ht)
    x0, x1, fx = axis_weights(w, wt)
    top = depth[y0][:, x0] * (1 - fx) + depth[y0][:, x1] * fx
    bot = depth[y1][:, x0] * (1 - fx) + depth[y1][:, x1] * fx
    return (top * (1 - fy[:, None]) + bot * fy[:, None]).astype(np.float32)


def normalize_image(x: np.ndarray) -> np.ndarray:
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def translate(x: np.ndarray, tx: int, ty: int) -> np.ndarray:
    """Zero-padded integer translation (torchvision affine translate
    semantics used by rand_shake, megadepth.py:104-109)."""
    out = np.zeros_like(x)
    h, w = x.shape[:2]
    src_y = slice(max(0, -ty), min(h, h - ty))
    dst_y = slice(max(0, ty), min(h, h + ty))
    src_x = slice(max(0, -tx), min(w, w - tx))
    dst_x = slice(max(0, tx), min(w, w + tx))
    out[dst_y, dst_x] = x[src_y, src_x]
    return out


def horizontal_flip_pair(im_A, im_B, depth_A, depth_B, K_A, K_B, wt: int):
    """Flip both images + depths, fix intrinsics (megadepth.py:78-90)."""
    flip = np.array([[-1, 0, wt], [0, 1, 0], [0, 0, 1]], np.float32)
    return (
        im_A[:, ::-1].copy(),
        im_B[:, ::-1].copy(),
        depth_A[:, ::-1].copy(),
        depth_B[:, ::-1].copy(),
        flip @ K_A,
        flip @ K_B,
    )


def random_perspective_matrix(
    rng: np.random.RandomState, h: int, w: int, distortion: float = 0.2
) -> np.ndarray:
    """Random perspective homography (the kornia RandomPerspective equivalent
    used by GeometricSequential, reference utils/transforms.py:8-60)."""
    d = distortion
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    jitter = rng.uniform(-d, d, (4, 2)).astype(np.float32) * [w, h]
    dst = src + jitter
    # DLT for the 4-point homography
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, vt = np.linalg.svd(np.asarray(A, np.float64))
    H = vt[-1].reshape(3, 3)
    return (H / H[2, 2]).astype(np.float32)


def warp_perspective(x: np.ndarray, H: np.ndarray, fill: float = 0.0) -> np.ndarray:
    """Inverse-warp an HWC/HW array by homography H (bilinear, zeros fill)."""
    h, w = x.shape[:2]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], -1) @ np.linalg.inv(H).T.astype(np.float32)
    sx = pts[..., 0] / pts[..., 2]
    sy = pts[..., 1] / pts[..., 2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None] if x.ndim == 3 else sx - x0
    fy = (sy - y0)[..., None] if x.ndim == 3 else sy - y0
    out = np.zeros_like(x, dtype=np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0 + dy
            xx = x0 + dx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            vals = x[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            mask = valid[..., None] if x.ndim == 3 else valid
            out += np.where(mask, vals * wgt, fill)
    return out.astype(x.dtype)


class RandomErasing:
    """Joint image+depth random erasing (reference utils/transforms.py:70-118)."""

    def __init__(self, p: float = 0.0, scale: tuple[float, float] = (0.02, 0.33)):
        self.p = p
        self.scale = scale

    def __call__(self, rng: np.random.RandomState, image: np.ndarray, depth: np.ndarray):
        if rng.rand() > self.p:
            return image, depth
        h, w = image.shape[:2]
        area = h * w * rng.uniform(*self.scale)
        aspect = rng.uniform(0.3, 3.3)
        eh = int(round(np.sqrt(area * aspect)))
        ew = int(round(np.sqrt(area / aspect)))
        if eh >= h or ew >= w:
            return image, depth
        y = rng.randint(0, h - eh)
        x = rng.randint(0, w - ew)
        image = image.copy()
        depth = depth.copy()
        image[y : y + eh, x : x + ew] = 0
        depth[y : y + eh, x : x + ew] = 0
        return image, depth


class ColorJiggle:
    """Photometric color jitter on float HWC [0,1] images (the reference's
    ``colorjiggle_params`` flag — accepted by megadepth.py:29,61 but silently
    dropped by get_tuple_transform_ops (utils.py:164-173); implemented for
    real here with kornia.ColorJiggle semantics: per-sample uniform
    brightness/contrast/saturation factors and additive hue shift)."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05, p=1.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p = p

    def __call__(self, rng: np.random.RandomState, image: np.ndarray) -> np.ndarray:
        if rng.rand() > self.p:
            return image
        x = image.astype(np.float32)
        if self.brightness:
            x = x * rng.uniform(1 - self.brightness, 1 + self.brightness)
        if self.contrast:
            mean = x.mean()
            x = mean + (x - mean) * rng.uniform(1 - self.contrast, 1 + self.contrast)
        if self.saturation:
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            f = rng.uniform(1 - self.saturation, 1 + self.saturation)
            x = gray[..., None] + (x - gray[..., None]) * f
        if self.hue:
            # additive hue rotation via the YIQ approximation
            theta = rng.uniform(-self.hue, self.hue) * 2 * np.pi
            u, w2 = np.cos(theta), np.sin(theta)
            t_yiq = np.array(
                [[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]],
                np.float32,
            )
            t_rgb = np.linalg.inv(t_yiq).astype(np.float32)
            rot = np.array([[1, 0, 0], [0, u, -w2], [0, w2, u]], np.float32)
            x = x @ (t_rgb @ rot @ t_yiq).T
        return np.clip(x, 0.0, 1.0)


def rand_augment_pair(rng: np.random.RandomState, pil_A, pil_B, num_ops: int = 2,
                      magnitude: float = 0.3):
    """Photometric RandAugment applied identically to both PIL images (the
    reference's ``use_randaug`` flag, megadepth.py:73,133-134 — its
    ``rand_augment`` method was never committed upstream; this is a working
    equivalent restricted to geometry-preserving ops so the GT warp stays
    valid)."""
    from PIL import ImageEnhance, ImageOps

    ops = [
        lambda im, f: ImageOps.autocontrast(im),
        lambda im, f: ImageOps.equalize(im),
        lambda im, f: ImageOps.posterize(im, max(1, int(8 - 4 * abs(f - 1)))),
        lambda im, f: ImageOps.solarize(im, int(255 * (1 - abs(f - 1)))),
        lambda im, f: ImageEnhance.Color(im).enhance(f),
        lambda im, f: ImageEnhance.Contrast(im).enhance(f),
        lambda im, f: ImageEnhance.Brightness(im).enhance(f),
        lambda im, f: ImageEnhance.Sharpness(im).enhance(f),
    ]
    pil_A, pil_B = pil_A.convert("RGB"), pil_B.convert("RGB")
    for i in rng.choice(len(ops), size=num_ops, replace=False):
        op = ops[int(i)]
        # one factor draw per op — applied identically to both images
        f = 1 + magnitude * (rng.rand() * 2 - 1)
        pil_A = op(pil_A, f)
        pil_B = op(pil_B, f)
    return pil_A, pil_B
