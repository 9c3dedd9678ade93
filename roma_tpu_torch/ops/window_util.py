"""Kernel F: per-tile compaction of miss flags into fixup slots.

Replaces roma_tpu/ops/window_util.py:_compact_kernel (entry
``_compact_miss``): for each tile of T query flags, the positions of the
first ``kf`` set flags in query order, and the sentinel T in the slots left
over. The windowed samplers (ops/tile_window.py, graveyard/window_warp_v1.py)
use it to pick the out-of-window queries whose exact values the tile kernel
adds in.

On the H100 the kernel (csrc/compact_miss.cu) is bound by bytes; its design
note is in the source. :func:`compact_checks` picks its path before every
launch. A CPU tensor takes the plain version :func:`compact_miss_reference`.
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


INT_MAX = 2**31 - 1
# the paths of csrc/compact_miss.cu and their codes in its entry
PATH_CODES = {"generic": 0, "warp": 1, "block": 2}
WARP_T_MAX = 32 * 8  # the warp path: 8 flags a lane, one 8-byte word
BLOCK_T_MAX = 1024 * 16  # the block path: 16 flags a thread, one 16-byte vector


def compact_checks(miss: torch.Tensor, t: int, kf: int) -> str:
    """Kernel F's argument contract, before any launch: miss bool
    (bnt, 1, t), contiguous (a bool tensor carries no gradient); t >= 1,
    kf >= 0, bnt and kf 32-bit ints and t at most INT_MAX - 1024 (the generic
    path's chunk indices stay ints); ValueError otherwise. Picks the path:
    "warp" when t % 8 == 0, t <= WARP_T_MAX and the base is 8-byte aligned;
    else "block" when t % 16 == 0, t <= BLOCK_T_MAX and the base is 16-byte
    aligned; else "generic" (any t, any base)."""
    if miss.dtype != torch.bool or miss.ndim != 3 or tuple(miss.shape[1:]) != (1, t) or t < 1 or kf < 0:
        raise ValueError(f"compact_miss: miss must be bool (bnt, 1, {t}) with T >= 1 and kf >= 0, got "
                         f"{miss.dtype} {tuple(miss.shape)}, kf {kf}")
    if not miss.is_contiguous():
        raise ValueError("compact_miss: miss must be contiguous")
    if max(miss.shape[0], kf) > INT_MAX or t > INT_MAX - 1024:
        raise ValueError(f"compact_miss: bnt and kf must be 32-bit ints and T at most {INT_MAX - 1024}, got "
                         f"{tuple(miss.shape)}, kf {kf}")
    addr = miss.data_ptr()
    if t % 8 == 0 and t <= WARP_T_MAX and addr % 8 == 0:
        return "warp"
    if t % 16 == 0 and t <= BLOCK_T_MAX and addr % 16 == 0:
        return "block"
    return "generic"


def compact_miss(miss: torch.Tensor, t: int, kf: int) -> torch.Tensor:
    """(bnt, 1, T) bool -> (bnt, kf, 1) int32 miss positions, sentinel T."""
    if miss.shape[1:] != (1, t) or miss.dtype != torch.bool:
        raise ValueError(f"compact_miss: miss must be bool (bnt, 1, {t}), got {miss.dtype} {tuple(miss.shape)}")
    if miss.device.type == "cpu":
        return compact_miss_reference(miss, t, kf)
    if not miss.is_cuda:
        raise ValueError(f"compact_miss: miss must be on a CUDA device or the CPU, got {miss.device}")
    path = compact_checks(miss, t, kf)
    bnt = miss.shape[0]
    out = torch.empty((bnt, kf, 1), dtype=torch.int32, device=miss.device)
    if bnt == 0 or kf == 0:
        return out
    rc = _ext.lib().roma_compact_miss(miss.data_ptr(), out.data_ptr(), bnt, t, kf, PATH_CODES[path],
                                      _ext.stream())
    _ext.check(rc, "compact_miss")
    compact_miss.launches += 1
    return out


compact_miss.launches = 0
