"""Windowed tile sampler v1 (counterpart of graveyard/window_warp_v1.py).

``windowed_grid_sample(x, grid)`` is the exact ``grid_sample(x, grid)``
(bilinear, zeros padding, ``align_corners=False``) by the v1 plan: 64x64
query tiles, each with a 128x192 window of the image zero-padded by ``pm``,
centred on the tile's raw mean target (x origin quantised to ``xq``). Every
out-of-window query is a miss, fixed up from an exact four-tap value in one
of the tile's ``kf`` slots; if any tile has more than ``kf`` misses, the
whole batch takes the four-tap formula (v1 has no per-tile recompute).

Kernels on the card: F (``compact_miss``) and Kernel G's v1 entry
(:func:`~roma_tpu_torch.ops.tile_window.warp_tiles_v1`). The exact branches
count their calls in ``windowed_grid_sample.branches``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.grid_sample import grid_sample
from ..ops.tile_window import _fixups, _tile_fields, _untile, warp_tiles_v1


@dataclass(frozen=True)
class WindowSpec:
    th: int = 64       # query tile height
    tw: int = 64       # query tile width
    wh: int = 128      # window rows
    ww: int = 192      # window cols (multiple of XQ + tile extent margin)
    xq: int = 64       # window x-origin quantum
    pm: int = 32       # zero-pad margin around the image
    kf: int = 64       # per-tile fixup slots

    @property
    def t(self) -> int:
        return self.th * self.tw


def _pick_origin(vals, lo_len, win_len, quantum=1):
    """Clamped, quantized window origin centered on the mean target."""
    o = torch.round(vals.mean(-1) - win_len / 2).to(torch.int32)
    if quantum > 1:
        o = torch.round(o.float() / quantum).to(torch.int32) * quantum
    return o.clamp(0, lo_len - win_len)


def _plan(grid, h, w, spec):
    """The v1 plan: padded-image corners and fractions per tile, window
    origins from the raw mean, window-local corners and the miss mask."""
    b, hq, wq = grid.shape[:3]
    th, tw, wh, ww, xq, pm = spec.th, spec.tw, spec.wh, spec.ww, spec.xq, spec.pm
    g = grid.reshape(b, hq * wq, 2).float()
    ix = (g[..., 0] + 1) * w / 2 - 0.5
    iy = (g[..., 1] + 1) * h / 2 - 0.5
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    y0 = y0f.to(torch.int32) + pm  # padded-image coords
    x0 = x0f.to(torch.int32) + pm
    y0t, (nh, nw) = _tile_fields(y0, hq, wq, th, tw)
    x0t, _ = _tile_fields(x0, hq, wq, th, tw)
    fyt, _ = _tile_fields(iy - y0f, hq, wq, th, tw)
    fxt, _ = _tile_fields(ix - x0f, hq, wq, th, tw)

    # make (Wp' - WW) a non-negative multiple of XQ
    wpx = ww + max(0, -(-(w + 2 * pm - ww) // xq)) * xq
    oy = _pick_origin(y0t.float(), h + 2 * pm, wh)
    jx = _pick_origin(x0t.float(), wpx, ww, xq) // xq
    yl = y0t - oy[..., None]
    xl = x0t - (jx * xq)[..., None]
    miss = ~((yl >= 0) & (yl <= wh - 2) & (xl >= 0) & (xl <= ww - 2))
    return dict(nh=nh, nw=nw, nt=nh * nw, y0t=y0t, x0t=x0t, fyt=fyt, fxt=fxt,
                oy=oy, jx=jx, yl=yl, xl=xl, miss=miss)


def windowed_grid_sample(x: torch.Tensor, grid: torch.Tensor, spec: WindowSpec = WindowSpec()) -> torch.Tensor:
    """Exact ``grid_sample`` of x (B, H, W, C) at grid (B, Hq, Wq, 2) by the
    v1 windowed plan; the four-tap formula over the batch when any tile has
    more than ``spec.kf`` out-of-window queries."""
    b, h, w, c = x.shape
    hq, wq = grid.shape[1], grid.shape[2]
    kf, pm = spec.kf, spec.pm
    if h + 2 * pm < spec.wh or w + 2 * pm < spec.ww:
        windowed_grid_sample.branches["small_image"] += 1
        return grid_sample(x, grid)  # image smaller than the window

    p = _plan(grid, h, w, spec)
    if not bool((p["miss"].sum(-1) <= kf).all()):
        windowed_grid_sample.branches["exact"] += 1
        return grid_sample(x, grid)  # a tile overflowed its fixup budget

    out = warp_tiles_v1(*_tile_args(x, p, spec))
    return _untile(out, b, p["nh"], p["nw"], spec.th, spec.tw, hq, wq)


def _tile_args(x, p, spec):
    """Kernel G's v1 arguments from the plan, every miss fixed up."""
    bnt, t, pm = x.shape[0] * p["nt"], spec.t, spec.pm
    y0t, x0t, fyt, fxt = (p[k].reshape(bnt, t) for k in ("y0t", "x0t", "fyt", "fxt"))
    fpos, fval = _fixups(x, p["miss"].reshape(bnt, t), y0t - pm, x0t - pm, fyt, fxt, p["nt"], spec.kf)
    return (x, p["yl"].reshape(bnt, t), p["xl"].reshape(bnt, t), fyt, fxt, p["oy"].reshape(bnt),
            (p["jx"] * spec.xq).reshape(bnt), fpos, fval, spec.wh, spec.ww, pm)


windowed_grid_sample.branches = {"small_image": 0, "exact": 0}
