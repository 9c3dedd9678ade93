"""Kernels K and L: the functions of tools/bench_onehot_dots.py's two Pallas
microbenchmarks, the one-hot row pick and the window fetch-and-sum.

:func:`onehot_dot` (Kernel K; entries :func:`onehot_dot_f32` and
:func:`onehot_dot_2bf16`) replaces the tool's ``_kern_f32`` and
``_kern_2bf16``: per tile ``i`` and query ``q``,
``o[i, 0, q] = (1 - fy) win[i, yl, 0] + fy win[i, yl + 1, 0]``, a row
outside ``[0, WH)`` contributing 0, which the TPU kernels read off row 0 of
a whole one-hot contraction. :func:`window_sum` (Kernel L) replaces the
tool's ``_dma_kernel``: per tile the float32 sum of a ``(WH, NS, XQC)``
window of a ``(B, HP, NJ, XQC)`` table at ``(img, oy, jx)``. Both kernels
are csrc/onehot_dots.cu, whose note gives the Hopper design; a CPU tensor
takes the plain versions here. Their caller is
roma_tpu_torch/tools/bench_onehot_dots.py.
"""
from __future__ import annotations

import torch

from .. import _ext

FORMS = ("f32", "2bf16")


def onehot_dot_reference(win: torch.Tensor, yl: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Plain version of both forms: the two exact row picks of column 0,
    ``t0 (1 - fy) + t1 fy`` in float32. Both forms are these two products
    and one sum (the one-hot dot's other terms are zeros); on the card the
    f32 entry fuses them as a dot accumulates, the 2bf16 entry rounds each
    product."""
    nt, wh, _ = win.shape
    col = win[:, :, 0].float()  # (NT, WH)

    def pick(rows):
        ok = (rows >= 0) & (rows < wh)
        return torch.gather(col, 1, rows.clamp(0, wh - 1).reshape(nt, -1).long()).view_as(rows) * ok

    return pick(yl) * (1.0 - fy) + pick(yl + 1) * fy


def onehot_dot(win: torch.Tensor, yl: torch.Tensor, fy: torch.Tensor, form: str = "f32") -> torch.Tensor:
    """win (NT, WH, CWW) bf16, yl int32 and fy float32 (NT, 1, T) ->
    (NT, 1, T) float32, in ``form`` ("f32" or "2bf16"): Kernel K."""
    if form not in FORMS:
        raise ValueError(f"onehot_dot: form {form!r} not in {FORMS}")
    if win.device.type == "cpu":
        return onehot_dot_reference(win, yl, fy)
    what = f"onehot_dot_{form}"
    _ext.require_cuda(what, win, yl, fy)
    nt, wh, cww = win.shape
    t = yl.shape[-1]
    if (win.dtype != torch.bfloat16 or yl.dtype != torch.int32 or fy.dtype != torch.float32
            or tuple(yl.shape) != (nt, 1, t) or tuple(fy.shape) != (nt, 1, t)):
        raise ValueError(f"{what}: expected win (NT, WH, CWW) bfloat16, yl int32 and fy float32 (NT, 1, T); "
                         f"got {win.dtype} {tuple(win.shape)}, {yl.dtype} {tuple(yl.shape)}, "
                         f"{fy.dtype} {tuple(fy.shape)}")
    out = torch.empty(nt, 1, t, dtype=torch.float32, device=win.device)
    rc = _ext.lib().roma_onehot_dot(win.data_ptr(), yl.data_ptr(), fy.data_ptr(), out.data_ptr(),
                                    nt, wh, cww, t, int(form == "2bf16"), _ext.stream())
    _ext.check(rc, what)
    onehot_dot.launches += 1
    return out


onehot_dot.launches = 0


def onehot_dot_f32(win, yl, fy):
    """Kernel K's entry for tools/bench_onehot_dots.py:_kern_f32."""
    return onehot_dot(win, yl, fy, "f32")


def onehot_dot_2bf16(win, yl, fy):
    """Kernel K's entry for tools/bench_onehot_dots.py:_kern_2bf16."""
    return onehot_dot(win, yl, fy, "2bf16")


def window_rows(tab: torch.Tensor, oy: torch.Tensor, jx: torch.Tensor, img: torch.Tensor,
                wh: int, ns: int) -> torch.Tensor:
    """(NT, WH, NS) row indices of each tile's window in ``tab`` seen as
    (B * HP * NJ, XQC) rows, the gather of tools/bench_onehot_dots.py:165-172."""
    _, hp, nj, _ = tab.shape
    r = torch.arange(wh, device=oy.device)
    s = torch.arange(ns, device=oy.device)
    return ((img.long()[:, None, None] * hp + oy.long()[:, None, None] + r[None, :, None]) * nj
            + jx.long()[:, None, None] + s[None, None, :])


def window_sum_reference(tab: torch.Tensor, oy: torch.Tensor, jx: torch.Tensor, img: torch.Tensor,
                         wh: int, ns: int) -> torch.Tensor:
    """Plain version: gather each tile's window rows and sum them in float32;
    a tile whose window leaves the table gets NaN."""
    b, hp, nj, xqc = tab.shape
    ok = (img >= 0) & (img < b) & (oy >= 0) & (oy + wh <= hp) & (jx >= 0) & (jx + ns <= nj)
    rows = window_rows(tab, oy, jx, img, wh, ns).clamp(0, b * hp * nj - 1).reshape(-1)
    win = tab.reshape(-1, xqc).index_select(0, rows).view(oy.shape[0], -1)
    total = win.sum(1, dtype=torch.float32)
    return torch.where(ok, total, torch.full_like(total, float("nan")))[:, None]


def window_sum(tab: torch.Tensor, oy: torch.Tensor, jx: torch.Tensor, img: torch.Tensor,
               wh: int, ns: int) -> torch.Tensor:
    """tab (B, HP, NJ, XQC) bf16, oy / jx / img int32 (NT,) -> (NT, 1)
    float32 window sums: Kernel L (XQC a multiple of 8 on the card)."""
    if tab.device.type == "cpu":
        return window_sum_reference(tab, oy, jx, img, wh, ns)
    what = "window_sum"
    _ext.require_cuda(what, tab, oy, jx, img)
    b, hp, nj, xqc = tab.shape
    nt = oy.shape[0]
    if (tab.dtype != torch.bfloat16 or xqc % 8 or wh < 1 or ns < 1
            or any(t.dtype != torch.int32 or tuple(t.shape) != (nt,) for t in (oy, jx, img))):
        raise ValueError(f"{what}: expected tab (B, HP, NJ, XQC) bfloat16 with XQC % 8 == 0, int32 (NT,) "
                         f"oy, jx, img and WH, NS >= 1; got {tab.dtype} {tuple(tab.shape)}, "
                         f"{[(t.dtype, tuple(t.shape)) for t in (oy, jx, img)]}, WH {wh}, NS {ns}")
    out = torch.empty(nt, 1, dtype=torch.float32, device=tab.device)
    rc = _ext.lib().roma_window_sum(tab.data_ptr(), oy.data_ptr(), jx.data_ptr(), img.data_ptr(),
                                    out.data_ptr(), nt, b, hp, nj, xqc, wh, ns, _ext.stream())
    _ext.check(rc, what)
    window_sum.launches += 1
    return out


window_sum.launches = 0
