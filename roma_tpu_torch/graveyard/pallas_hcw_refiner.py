"""Wide-C folded refiner stack in the (B, H, C, W) layout (counterpart of
graveyard/pallas_hcw_refiner.py).

``hcw_refiner_stack(x, blocks)`` takes NHWC x (B, H, W, C), transposes it
once to (B, H, C, W), runs one launch of Kernel J
(:func:`~roma_tpu_torch.ops.wide_refiner.hcw_refiner_block`) a folded block,
and transposes back, as the JAX entry does around its chain. The TPU
kernel's channel pad to 8 and width pad to 128 are tiling details it needs
and Kernel J does not; Kernel J takes all four released widths (C 144 to
1377), where the TPU kernel did not compile at C >= 569. Not routed by the
match path (roma_tpu_torch/tools/bench_hcw_refiner.py compares it with the
model's cuDNN stack on the H100).
"""
from __future__ import annotations

import torch

from ..ops.wide_refiner import hcw_refiner_block


def hcw_refiner_stack(x: torch.Tensor, blocks: list[dict], s_rows: int | None = None) -> torch.Tensor:
    """Folded refiner chain on NHWC ``x`` via the (B, H, C, W) kernel.

    ``s_rows`` is the JAX entry's strip height, a tiling knob that changes
    nothing in the output; Kernel J's 8x8 pixel tile is fixed, so it is
    only checked.
    """
    if s_rows is not None and s_rows < 1:
        raise ValueError(f"hcw_refiner_stack: s_rows={s_rows} must be >= 1")
    xt = x.permute(0, 1, 3, 2).contiguous()  # (B, H, C, W)
    for blk in blocks:
        xt = hcw_refiner_block(xt, blk)
    return xt.permute(0, 1, 3, 2).contiguous()
