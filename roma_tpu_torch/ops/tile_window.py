"""Windowed tile sampler v2 (counterpart of roma_tpu/ops/tile_window.py:64-470).

``windowed_warp(x, flow)`` is the exact ``grid_sample(x, flow)`` (bilinear,
zeros padding, ``align_corners=False``) computed tile by tile, as the JAX
package's v2 sampler plans it: a 16x16 query tile's bilinear targets cluster
in a window of the image zero-padded by ``pm``, placed at the tile's mean
target with coordinates clipped into the padded range first. Every query is
(a) in its window, sampled there by the tile kernel; (b) out of window but
touching the image, fixed up from an exact four-tap value in one of the
tile's ``kf`` slots; (c) wholly off the image, 0; or (d) in a tile with more
than ``kf`` such misses, recomputed by the plain four-tap formula. When more
than ``nt_bad`` tiles overflow, the whole batch takes the four-tap formula.

Kernels on the card: F (:func:`~roma_tpu_torch.ops.window_util.compact_miss`)
picks the slots, G (:func:`warp_tiles`, csrc/window_warp.cu) samples the
tiles and adds the fixups; :func:`warp_tiles_v1` is G's entry for the v1
sampler of graveyard/window_warp_v1.py. A CPU tensor takes the plain
versions (:func:`warp_tiles_reference`). The exact branches are the JAX
function's own semantics; each counts its calls in ``windowed_warp.branches``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _ext
from ..utils.profiling import spanned
from .grid_sample import grid_sample
from .window_util import compact_miss


@dataclass(frozen=True)
class WarpSpec:
    th: int = 16        # query tile height
    tw: int = 16        # query tile width
    wh: int = 64        # window rows
    xq: int = 64        # x segment quantum (window origin granularity)
    ns: int = 2         # segments per window; window cols ww = ns*xq
    pm: int = 32        # zero-pad margin around the image
    kf: int = 32        # per-tile fixup slots
    nt_bad: int = 64    # min over-budget tiles recomputed exactly per batch
    dots: str = "bf16x2"  # the TPU kernel's window contraction; both give the same result

    @property
    def t(self) -> int:
        return self.th * self.tw

    @property
    def ww(self) -> int:
        return self.ns * self.xq


def _edge_pad(a: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(B, H, W) padded at the bottom and right by repeating the edge."""
    rows = torch.arange(a.shape[1] + ph, device=a.device).clamp(max=a.shape[1] - 1)
    cols = torch.arange(a.shape[2] + pw, device=a.device).clamp(max=a.shape[2] - 1)
    return a[:, rows][:, :, cols]


def _tile_fields(a, hq, wq, th, tw):
    """(B, Hq*Wq) -> (B, nt, T) tile-major (edge-padded partial tiles)."""
    b = a.shape[0]
    a = a.reshape(b, hq, wq)
    ph, pw = (-hq) % th, (-wq) % tw
    if ph or pw:
        a = _edge_pad(a, ph, pw)
    nh, nw = a.shape[1] // th, a.shape[2] // tw
    a = a.reshape(b, nh, th, nw, tw).permute(0, 1, 3, 2, 4)
    return a.reshape(b, nh * nw, th * tw), (nh, nw)


def _untile(out: torch.Tensor, b, nh, nw, th, tw, hq, wq) -> torch.Tensor:
    """(B*nt, T, C) tile-major -> (B, Hq, Wq, C), the partial tiles cropped."""
    c = out.shape[-1]
    out = out.reshape(b, nh, nw, th, tw, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, nh * th, nw * tw, c)[:, :hq, :wq].contiguous()


def _exact_taps(x_flat, img_rows, y0, x0, fy, fx, h, w, c):
    """Masked 4-tap bilinear from flat (B*H*W, C) rows; all args (..., )
    index arrays in ORIGINAL image coords. Returns (..., C) f32."""
    acc = torch.zeros(y0.shape + (c,), dtype=torch.float32, device=x_flat.device)
    fy = fy[..., None]
    fx = fx[..., None]
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0.long() + dy, x0.long() + dx
        v = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        rows = img_rows + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        acc = acc + x_flat[rows].float() * (wgt * v[..., None])
    return acc


def _plan(flow, h, w, spec):
    """The windowing plan: tile-major index fields, window origins, in-window
    tests and the needs-fix mask (out of window AND touching the image)."""
    b, hq, wq = flow.shape[:3]
    th, tw, wh, xq, ns, pm = spec.th, spec.tw, spec.wh, spec.xq, spec.ns, spec.pm
    ww = spec.ww

    g = flow.reshape(b, hq * wq, 2).float()
    ix = (g[..., 0] + 1) * w / 2 - 0.5
    iy = (g[..., 1] + 1) * h / 2 - 0.5
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    fx, fy = ix - x0f, iy - y0f
    y0, x0 = y0f.to(torch.int32), x0f.to(torch.int32)

    y0t, (nh, nw) = _tile_fields(y0, hq, wq, th, tw)
    x0t, _ = _tile_fields(x0, hq, wq, th, tw)
    fyt, _ = _tile_fields(fy, hq, wq, th, tw)
    fxt, _ = _tile_fields(fx, hq, wq, th, tw)

    hp = h + 2 * pm
    wpx = -(-(w + 2 * pm) // xq) * xq
    njq = wpx // xq

    # bounded-influence origins: clip into the padded range BEFORE the mean
    ypc = (y0t + pm).clamp(0, hp - 1).float()
    xpc = (x0t + pm).clamp(0, wpx - 1).float()
    oy = torch.round(ypc.mean(-1) - wh / 2).to(torch.int32).clamp(0, hp - wh)
    jx = torch.round((xpc.mean(-1) - ww / 2) / xq).to(torch.int32).clamp(0, njq - ns)

    yl = (y0t + pm) - oy[..., None]
    xl = (x0t + pm) - (jx * xq)[..., None]
    inw = (yl >= 0) & (yl <= wh - 2) & (xl >= 0) & (xl <= ww - 2)
    touches = (y0t >= -1) & (y0t <= h - 1) & (x0t >= -1) & (x0t <= w - 1)
    needfix = ~inw & touches
    return dict(b=b, hq=hq, wq=wq, nt=nh * nw, nh=nh, nw=nw, hp=hp, wpx=wpx, njq=njq,
                y0t=y0t, x0t=x0t, fyt=fyt, fxt=fxt, yl=yl, xl=xl,
                oy=oy, jx=jx, needfix=needfix, counts=needfix.sum(-1))


def warp_tiles_reference(x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm):
    """Plain PyTorch version of Kernel G, tile by tile.

    x (B, H, W, C); yl, xl (B*nt, T) int32 window-local corner; fy, fx
    (B*nt, T) f32 fractions; oy, ox (B*nt,) int32 window origin in the image
    zero-padded by pm; fpos (B*nt, kf, 1) int32 fixup positions (sentinel
    T); fval (B*nt, kf, C) f32 fixup values. Returns (B*nt, T, C) in x's
    dtype: the in-window bilinear value from the padded image (0 out of
    window) plus the slot's fixup, rounded once.
    """
    b, h, w, c = x.shape
    bnt, t = yl.shape
    ok = (yl >= 0) & (yl <= wh - 2) & (xl >= 0) & (xl <= ww - 2)
    img_rows = (torch.arange(bnt, device=x.device) // (bnt // b) * (h * w))[:, None]
    # a padded-window position outside the image is a zero of the padding
    val = _exact_taps(x.reshape(b * h * w, c), img_rows, (oy - pm)[:, None] + yl, (ox - pm)[:, None] + xl,
                      fy, fx, h, w, c)
    val = torch.where(ok[..., None], val, 0.0)
    fix = torch.zeros(bnt, t + 1, c, dtype=torch.float32, device=x.device)
    slot = fpos[:, :, 0].long().clamp(0, t)  # the sentinel T lands in column T, dropped
    fix.scatter_add_(1, slot[..., None].expand(-1, -1, c), fval.float())
    return (val + fix[:, :t]).to(x.dtype)


_FIELDS = ("x", "yl", "xl", "fy", "fx", "oy", "ox", "fpos", "fval")
_FIELD_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.int32, torch.int32, torch.int32,
                 torch.float32)


def tile_checks(what, x, yl, xl, fy, fx, oy, ox, fpos, fval):
    """Kernel G's argument contract, in one pass: the dtypes and shapes of
    :func:`warp_tiles_reference`, the tiles a whole number per image, every
    tensor contiguous and on x's device (ValueError); x not requiring a
    gradient (RuntimeError). Returns (B, H, W, C, tiles, T, kf)."""
    b, h, w, c = x.shape
    bnt, t = yl.shape
    kf = fpos.shape[1]
    ts = (x, yl, xl, fy, fx, oy, ox, fpos, fval)
    dev = x.get_device()
    if ((yl.dtype, xl.dtype, fy.dtype, fx.dtype, oy.dtype, ox.dtype, fpos.dtype, fval.dtype) != _FIELD_DTYPES
            or not xl.shape == fy.shape == fx.shape == yl.shape or oy.shape != (bnt,) or ox.shape != (bnt,)
            or fpos.shape != (bnt, kf, 1) or fval.shape != (bnt, kf, c) or bnt % b
            or not all(a.is_contiguous() and a.get_device() == dev for a in ts)):
        got = ", ".join(f"{n} {a.dtype} {tuple(a.shape)}{'' if a.is_contiguous() else ' strided'} on {a.device}"
                        for n, a in zip(_FIELDS, ts))
        raise ValueError(f"{what}: want x (B, H, W, C) and warp_tiles_reference's int32 / float32 tile fields, "
                         f"contiguous, on x's device, the tiles a whole number per image; got {got}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    return b, h, w, c, bnt, t, kf


_ENTRIES: dict = {}  # the bound C entry points, so that a call takes no lock


def _tiles(entry, fn, x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm):
    """Shared wrapper of Kernel G's two entries (see warp_tiles): ``entry``
    names the C entry point, ``fn`` the wrapper that counts the launch."""
    if x.device.type == "cpu":
        return warp_tiles_reference(x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm)
    name = fn.__name__
    if not x.is_cuda:
        raise ValueError(f"{name}: tensors must be on a CUDA device or the CPU, got {x.device}")
    b, h, w, c, bnt, t, kf = tile_checks(name, x, yl, xl, fy, fx, oy, ox, fpos, fval)
    code = _ext.dtype_code(x, name)
    out = torch.empty((bnt, t, c), dtype=x.dtype, device=x.device)
    if bnt == 0:
        return out
    launch = _ENTRIES.get(entry) or _ENTRIES.setdefault(entry, getattr(_ext.lib(), entry))
    rc = launch(x.data_ptr(), yl.data_ptr(), xl.data_ptr(), fy.data_ptr(), fx.data_ptr(), oy.data_ptr(),
               ox.data_ptr(), fpos.data_ptr(), fval.data_ptr(), out.data_ptr(), bnt, bnt // b,
               h, w, c, t, kf, wh, ww, pm, code, _ext.stream())
    _ext.check(rc, name)
    fn.launches += 1
    return out


@spanned("roma.ops.warp_tiles")
def warp_tiles(x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm):
    """Kernel G, the v2 entry (replaces roma_tpu/ops/tile_window.py:_warp_kernel).
    Arguments and result as :func:`warp_tiles_reference`."""
    return _tiles("roma_window_warp", warp_tiles, x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm)


@spanned("roma.ops.warp_tiles_v1")
def warp_tiles_v1(x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm):
    """Kernel G, the v1 entry (replaces graveyard/window_warp_v1.py:_kernel):
    the same function, launched for 64x64 tiles."""
    return _tiles("roma_window_warp_v1", warp_tiles_v1, x, yl, xl, fy, fx, oy, ox, fpos, fval, wh, ww, pm)


warp_tiles.launches = 0
warp_tiles_v1.launches = 0


def windowed_warp(x: torch.Tensor, flow: torch.Tensor, spec: WarpSpec = WarpSpec()) -> torch.Tensor:
    """Exact ``grid_sample(x, flow)`` (bilinear, zeros, align_corners=False)
    via the windowed tile kernel. x (B,H,W,C); flow (B,Hq,Wq,2) in [-1,1]."""
    b, h, w, c = x.shape
    hq, wq = flow.shape[1], flow.shape[2]
    th, tw, wh, xq, pm, kf, t = spec.th, spec.tw, spec.wh, spec.xq, spec.pm, spec.kf, spec.t

    if h + 2 * pm < wh or -(-(w + 2 * pm) // xq) * xq < spec.ww + xq:
        windowed_warp.branches["small_image"] += 1
        return grid_sample(x, flow)  # image smaller than a window

    p = _plan(flow, h, w, spec)
    nt = p["nt"]
    bnt = b * nt
    counts = p["counts"].reshape(bnt)
    over = counts > kf
    n_over = int(over.sum())
    if n_over > min(max(spec.nt_bad, bnt // 24), bnt):
        # more over-budget tiles than the recompute takes: the four-tap
        # formula over every query (the JAX function's lean fallback)
        windowed_warp.branches["exact"] += 1
        return grid_sample(x, flow)

    args = _tile_args(x, p, spec)
    out = warp_tiles(*args)
    if n_over:  # exact recompute of the over-budget tiles
        bad = over.nonzero()[:, 0]
        img_rows = (bad // nt * (h * w))[:, None]
        out[bad] = _exact_taps(x.reshape(b * h * w, c), img_rows,
                               *(p[k].reshape(bnt, t)[bad] for k in ("y0t", "x0t", "fyt", "fxt")),
                               h, w, c).to(x.dtype)
        windowed_warp.branches["tile_recompute"] += n_over
    return _untile(out, b, p["nh"], p["nw"], th, tw, hq, wq)


def _fixups(x, flags, y0t, x0t, fyt, fxt, nt, kf):
    """Kernel F compacts each tile's flagged queries into ``kf`` slots
    (sentinel T); the fixup values are their exact four taps. Fields are
    (B*nt, T), corners in image coords. Returns (fpos, fval)."""
    b, h, w, c = x.shape
    bnt, t = flags.shape
    fpos = compact_miss(flags.reshape(bnt, 1, t), t, kf)
    sel = fpos[:, :, 0].long().clamp(max=t - 1)
    img_rows = (torch.arange(bnt, device=x.device) // nt * (h * w))[:, None]
    fval = _exact_taps(x.reshape(b * h * w, c), img_rows, *(a.gather(1, sel) for a in (y0t, x0t, fyt, fxt)),
                       h, w, c)
    return fpos, fval


def _tile_args(x, p, spec):
    """Kernel G's arguments from the plan, the needs-fix queries fixed up."""
    bnt, t = x.shape[0] * p["nt"], spec.t
    y0t, x0t, fyt, fxt = (p[k].reshape(bnt, t) for k in ("y0t", "x0t", "fyt", "fxt"))
    fpos, fval = _fixups(x, p["needfix"].reshape(bnt, t), y0t, x0t, fyt, fxt, p["nt"], spec.kf)
    return (x, p["yl"].reshape(bnt, t), p["xl"].reshape(bnt, t), fyt, fxt, p["oy"].reshape(bnt),
            (p["jx"] * spec.xq).reshape(bnt), fpos, fval, spec.wh, spec.ww, spec.pm)


windowed_warp.branches = {"small_image": 0, "exact": 0, "tile_recompute": 0}
