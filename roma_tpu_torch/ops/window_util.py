"""Kernel F: per-tile compaction of miss flags into fixup slots.

Replaces roma_tpu/ops/window_util.py:_compact_kernel (entry
``_compact_miss``): for each tile of T query flags, the positions of the
first ``kf`` set flags in query order, and the sentinel T in the slots left
over. The windowed samplers (ops/tile_window.py, graveyard/window_warp_v1.py)
use it to pick the out-of-window queries whose exact values the tile kernel
adds in.

On the H100 the kernel (csrc/compact_miss.cu) is bound by bytes; its design
note is in the source. A CPU tensor takes the plain version
:func:`compact_miss_reference`.
"""
from __future__ import annotations

import torch

from .. import _ext


def _query_subblock(t: int, cap: int) -> int:
    """Largest divisor of ``t`` <= cap: the chunk a loop over t queries steps
    by without a remainder."""
    qs = min(t, cap)
    while t % qs:
        qs -= 1
    return qs


def compact_miss_reference(miss: torch.Tensor, t: int, kf: int) -> torch.Tensor:
    """Plain PyTorch version: rank each set flag by a running count and
    scatter its query index into slot ``rank`` when the rank is below kf."""
    m = miss.reshape(miss.shape[0], t)
    rank = torch.cumsum(m.to(torch.int32), dim=1) - 1
    slot = torch.where(m & (rank < kf), rank, torch.full_like(rank, kf)).long()
    q = torch.arange(t, dtype=torch.int32, device=m.device).expand_as(rank)
    pos = torch.full((m.shape[0], kf + 1), t, dtype=torch.int32, device=m.device)
    pos.scatter_(1, slot, q)  # column kf takes every rank >= kf and is dropped
    return pos[:, :kf, None].contiguous()


def compact_miss(miss: torch.Tensor, t: int, kf: int) -> torch.Tensor:
    """(bnt, 1, T) bool -> (bnt, kf, 1) int32 miss positions, sentinel T."""
    if miss.shape[1:] != (1, t) or miss.dtype != torch.bool:
        raise ValueError(f"compact_miss: miss must be bool (bnt, 1, {t}), got {miss.dtype} {tuple(miss.shape)}")
    if miss.device.type == "cpu":
        return compact_miss_reference(miss, t, kf)
    what = "compact_miss"
    _ext.require_cuda(what, miss)
    bnt = miss.shape[0]
    out = torch.empty((bnt, kf, 1), dtype=torch.int32, device=miss.device)
    if bnt == 0 or kf == 0:
        return out
    rc = _ext.lib().roma_compact_miss(miss.data_ptr(), out.data_ptr(), bnt, t, kf, _ext.stream())
    _ext.check(rc, what)
    compact_miss.launches += 1
    return out


compact_miss.launches = 0
