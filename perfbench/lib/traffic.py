"""Inputs made from a seed: textured image pairs and posed training pairs.

Frozen copies of the generators the program's own checks use, so that a
later change to the program cannot move the yardstick:

* :func:`texture` and :func:`synthetic_pair` are chip_smoke.py's: coloured
  blobs and a sine pattern, and a copy rotated, shifted and resampled;
* :func:`posed_pair` is tools/convergence_run.py's ``make_pair``: a
  textured plane fronto-parallel to camera A, seen by a camera B rotated by
  up to 2 degrees an axis and shifted, both rendered analytically with
  their depth maps, so the ground-truth warp is exact.

Every draw comes from a ``numpy.random.RandomState`` seeded by
:func:`sub_seed`, which folds any whole number (the benchmark's seeds pass
2**32) and a stream index into one 32-bit seed.
"""
from __future__ import annotations

import math

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def sub_seed(seed: int, *stream: int) -> int:
    """A 32-bit seed for stream ``stream`` of run ``seed`` (any whole number >= 0)."""
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(1)[0])


def texture(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1]: coloured blobs and a sine pattern."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    scale = min(h, w) / 720
    for _ in range(60):
        cy, cx, r = rs.uniform(0, h), rs.uniform(0, w), scale * rs.uniform(10, 80)
        img += rs.uniform(0, 1, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
    img += 0.15 * np.sin(xx / rs.uniform(5, 20))[..., None] * np.cos(yy / rs.uniform(5, 20))[..., None]
    return np.clip(img / img.max(), 0, 1)


def synthetic_pair(seed: int, hw=(720, 960)) -> tuple[Image.Image, Image.Image]:
    """A textured image and a copy rotated by up to 15 degrees and shifted
    by up to 40 pixels (bicubic)."""
    rs = np.random.RandomState(seed)
    im_a = Image.fromarray((texture(rs, *hw) * 255).astype(np.uint8))
    im_b = im_a.rotate(rs.uniform(-15, 15), resample=Image.BICUBIC,
                       translate=(rs.uniform(-40, 40), rs.uniform(-40, 40)))
    return im_a, im_b


# ---------------------------------------------------------------------------
# posed pairs for training
# ---------------------------------------------------------------------------

def _fourier_texture(rs: np.random.RandomState, n_comp: int = 10):
    """Smooth random Fourier texture R^2 -> [0,1]^3 (world-plane units)."""
    freq = rs.uniform(0.15, 1.6, (3, n_comp, 2))
    phase = rs.uniform(0, 2 * math.pi, (3, n_comp))
    amp = rs.uniform(0.3, 1.0, (3, n_comp)) / np.sqrt(n_comp)

    def f(x, y):
        arg = (freq[..., 0][:, :, None, None] * x[None, None] + freq[..., 1][:, :, None, None] * y[None, None]
               + phase[:, :, None, None])
        v = (amp[:, :, None, None] * np.sin(arg)).sum(1)
        v = 0.5 + 0.5 * v / (np.abs(v).max() + 1e-6)
        return np.transpose(v, (1, 2, 0)).astype(np.float32)

    return f


def _small_rotation(rs: np.random.RandomState, max_deg: float = 2.0) -> np.ndarray:
    a = np.deg2rad(rs.uniform(-max_deg, max_deg, 3))
    cx, sx, cy, sy, cz, sz = np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1]), np.cos(a[2]), np.sin(a[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float64)


def posed_draw(rs: np.random.RandomState):
    """A pair's random draws: depth, rotation, translation, texture."""
    d = rs.uniform(4.0, 8.0)
    rot = _small_rotation(rs)
    t = np.array([rs.uniform(-0.1, 0.1) * d, rs.uniform(-0.1, 0.1) * d, rs.uniform(-0.05, 0.05) * d])
    return d, rot, t, _fourier_texture(rs)


def posed_render(res: int, d, rot, t, tex) -> dict:
    """Render a drawn pair at res x res: ImageNet-normalized images (H, W, 3),
    depth maps, T_1to2 (4, 4) and K1 = K2 (3, 3), float32."""
    f = float(res)
    cx = cy = res / 2.0
    k = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)
    u = np.arange(res, dtype=np.float64) + 0.5
    uu, vv = np.meshgrid(u, u, indexing="xy")
    im_a = tex((uu - cx) / f * d, (vv - cy) / f * d)
    depth_a = np.full((res, res), d, np.float32)
    m = rot[:, 2]
    rx, ry = (uu - cx) / f, (vv - cy) / f
    s = (d + m @ t) / (m[0] * rx + m[1] * ry + m[2])
    xb, yb, zb = s * rx, s * ry, s
    p = np.stack([xb - t[0], yb - t[1], zb - t[2]], -1) @ rot
    im_b = tex(p[..., 0], p[..., 1])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = rot, t
    norm = lambda im: ((im - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    return {"im_A": norm(im_a), "im_B": norm(im_b), "im_A_depth": depth_a, "im_B_depth": zb.astype(np.float32),
            "T_1to2": T.astype(np.float32), "K1": k.astype(np.float32), "K2": k.astype(np.float32)}


def posed_batch(rs: np.random.RandomState, b: int, res: int, pool=None) -> dict:
    """``b`` posed pairs stacked; drawn in turn, rendered on ``pool`` when given."""
    draws = [posed_draw(rs) for _ in range(b)]
    items = list((pool.map if pool is not None else map)(lambda dr: posed_render(res, *dr), draws))
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
