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
are csrc/onehot_dots.cu, whose note gives the Hopper design; each wrapper
checks its arguments in one pure function (:func:`onehot_checks`,
:func:`window_sum_checks`), which also plans the launch. A CPU tensor takes
the plain versions here. Their caller is roma_tpu_torch/tools/bench_onehot_dots.py.
"""
from __future__ import annotations

import torch

from .. import _ext
from ..utils.profiling import spanned

FORMS = ("f32", "2bf16")
VEC_BYTES = 16  # K's vector path moves 4 queries of yl, fy and o at a time; L reads tab's rows so
INT_MAX = 2**31 - 1  # the C entries take 32-bit sizes
K_CHUNK = 4096  # queries a block of Kernel K (csrc/onehot_dots.cu KCHUNK)
K_MAX_T = INT_MAX - K_CHUNK  # so a chunk's last query index stays a 32-bit int
# K stages a tile's column 0 as WH floats in the 48 KB of shared memory a
# block gets without opting in to more
K_MAX_WH = 48 * 1024 // 4


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


def onehot_checks(what, win, yl, fy, form):
    """Kernel K's argument contract, in one pass, before any launch: form
    one of FORMS; win (NT, WH, CWW) bfloat16, yl int32 and fy float32
    (NT, 1, T), every size under 2^31, T at most K_MAX_T and WH at most
    K_MAX_WH (a block stages the tile's column 0, WH floats, in shared
    memory); all contiguous and on one device (ValueError); win not
    requiring a gradient (RuntimeError). Picks the path: "vector" (4 queries
    a thread, 16-byte loads of yl and fy) when T % 4 == 0 and yl's and fy's
    bases are 16-byte aligned, else "scalar" (a query a thread, any base).
    Returns (NT, WH, CWW, T, path, shared-memory bytes a block)."""
    if form not in FORMS:
        raise ValueError(f"{what}: form {form!r} not in {FORMS}")
    if win.ndim != 3 or yl.ndim != 3:
        raise ValueError(f"{what}: expected win (NT, WH, CWW) and yl, fy (NT, 1, T); got {tuple(win.shape)}, "
                         f"{tuple(yl.shape)}, {tuple(fy.shape)}")
    nt, wh, cww = win.shape
    t = yl.shape[-1]
    if (win.dtype != torch.bfloat16 or yl.dtype != torch.int32 or fy.dtype != torch.float32
            or tuple(yl.shape) != (nt, 1, t) or tuple(fy.shape) != (nt, 1, t) or min(wh, cww) < 1):
        raise ValueError(f"{what}: expected win (NT, WH, CWW) bfloat16, yl int32 and fy float32 (NT, 1, T); "
                         f"got {win.dtype} {tuple(win.shape)}, {yl.dtype} {tuple(yl.shape)}, "
                         f"{fy.dtype} {tuple(fy.shape)}")
    if not all(x.is_contiguous() and x.device == win.device for x in (win, yl, fy)):
        raise ValueError(f"{what}: win, yl and fy must be contiguous and on one device")
    if win.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    if wh > K_MAX_WH or max(nt, cww) > INT_MAX or t > K_MAX_T:
        raise ValueError(f"{what}: a block stages WH <= {K_MAX_WH} rows of column 0, T is at most {K_MAX_T} and "
                         f"every size is a 32-bit int; got win {tuple(win.shape)}, T {t}")
    aligned = yl.data_ptr() % VEC_BYTES == 0 and fy.data_ptr() % VEC_BYTES == 0
    path = "vector" if t % 4 == 0 and aligned else "scalar"
    return nt, wh, cww, t, path, 4 * wh


@spanned("roma.ops.onehot_dot")
def onehot_dot(win: torch.Tensor, yl: torch.Tensor, fy: torch.Tensor, form: str = "f32") -> torch.Tensor:
    """win (NT, WH, CWW) bf16, yl int32 and fy float32 (NT, 1, T) ->
    (NT, 1, T) float32, in ``form`` ("f32" or "2bf16"): Kernel K."""
    if form not in FORMS:
        raise ValueError(f"onehot_dot: form {form!r} not in {FORMS}")
    if win.device.type == "cpu":
        return onehot_dot_reference(win, yl, fy)
    what = f"onehot_dot_{form}"
    if not win.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {win.device}")
    nt, wh, cww, t, path, _ = onehot_checks(what, win, yl, fy, form)
    out = torch.empty(nt, 1, t, dtype=torch.float32, device=win.device)
    if out.numel() == 0:
        return out
    rc = _ext.lib().roma_onehot_dot(win.data_ptr(), yl.data_ptr(), fy.data_ptr(), out.data_ptr(), nt, wh, cww, t,
                                    int(form == "2bf16"), int(path == "vector"), _ext.stream())
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


def window_sum_checks(what, tab, oy, jx, img, wh, ns):
    """Kernel L's argument contract, in one pass, before any launch: tab
    (B, HP, NJ, XQC) bfloat16 with XQC a multiple of 8 and its base 16-byte
    aligned (phase 1 reads the rows by 16-byte vectors); oy, jx, img
    int32 (NT,); WH, NS ints >= 1; every size under 2^31; all contiguous and
    on one device (ValueError); tab not requiring a gradient (RuntimeError).
    Returns (B, HP, NJ, XQC, NT, the scratch's float count B * HP * NJ: a
    row sum or a covered-row flag a table row)."""
    if tab.ndim != 4 or tab.dtype != torch.bfloat16 or tab.shape[-1] % 8 or min(tab.shape) < 1:
        raise ValueError(f"{what}: expected tab (B, HP, NJ, XQC) bfloat16 with XQC a multiple of 8, got "
                         f"{tab.dtype} {tuple(tab.shape)}")
    b, hp, nj, xqc = tab.shape
    nt = oy.shape[0] if oy.ndim == 1 else -1
    if any(t.dtype != torch.int32 or tuple(t.shape) != (nt,) for t in (oy, jx, img)):
        raise ValueError(f"{what}: expected int32 (NT,) oy, jx, img; got "
                         f"{[(t.dtype, tuple(t.shape)) for t in (oy, jx, img)]}")
    if not (isinstance(wh, int) and isinstance(ns, int) and wh >= 1 and ns >= 1):
        raise ValueError(f"{what}: WH and NS must be ints >= 1, got {wh!r}, {ns!r}")
    if max(b, hp, nj, xqc, nt, wh * ns) > INT_MAX:
        raise ValueError(f"{what}: every size must be a 32-bit int, got tab {tuple(tab.shape)}, NT {nt}, "
                         f"WH {wh}, NS {ns}")
    if not all(t.is_contiguous() and t.device == tab.device for t in (tab, oy, jx, img)):
        raise ValueError(f"{what}: tab, oy, jx and img must be contiguous and on one device")
    if tab.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: forward-only kernel, no backward")
    if tab.data_ptr() % VEC_BYTES:
        raise ValueError(f"{what}: phase 1 reads tab's rows by 16-byte vectors and needs its base 16-byte "
                         f"aligned, got address {tab.data_ptr()} % 16 = {tab.data_ptr() % 16}")
    return b, hp, nj, xqc, nt, b * hp * nj


@spanned("roma.ops.window_sum")
def window_sum(tab: torch.Tensor, oy: torch.Tensor, jx: torch.Tensor, img: torch.Tensor,
               wh: int, ns: int) -> torch.Tensor:
    """tab (B, HP, NJ, XQC) bf16, oy / jx / img int32 (NT,) -> (NT, 1)
    float32 window sums: Kernel L (XQC a multiple of 8 on the card)."""
    if tab.device.type == "cpu":
        return window_sum_reference(tab, oy, jx, img, wh, ns)
    what = "window_sum"
    if not tab.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device or the CPU, got {tab.device}")
    b, hp, nj, xqc, nt, nrows = window_sum_checks(what, tab, oy, jx, img, wh, ns)
    out = torch.empty(nt, 1, dtype=torch.float32, device=tab.device)
    if nt == 0:
        return out
    rowsum = torch.empty(nrows, dtype=torch.float32, device=tab.device)
    rc = _ext.lib().roma_window_sum(tab.data_ptr(), oy.data_ptr(), jx.data_ptr(), img.data_ptr(),
                                    rowsum.data_ptr(), out.data_ptr(), nt, b, hp, nj, xqc, wh, ns, _ext.stream())
    _ext.check(rc, what)
    window_sum.launches += 3  # the marking pass, the row sums and the tile sums
    return out


window_sum.launches = 0
