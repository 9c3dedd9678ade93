"""Wide-C folded refiner stack on NHWC (counterpart of
graveyard/pallas_refiner_lanemajor.py).

``lane_refiner_stack(x, blocks)`` runs a chain of folded RefinerBlocks
(:func:`~roma_tpu_torch.ops.refiner_stack.fold_block` dicts) on x
(B, H, W, C), any C, one launch of Kernel I
(:func:`~roma_tpu_torch.ops.wide_refiner.lane_refiner_block`) a block. The
TPU's 128-lane channel pad and 8-row width pad are tiling details of its
kernel and have no counterpart here. Not routed by the match path: the JAX
package measured this design slower than its XLA convs, and the port's
match keeps cuDNN (roma_tpu_torch/tools/bench_hcw_refiner.py compares them
on the H100).
"""
from __future__ import annotations

import torch

from ..ops.wide_refiner import lane_refiner_block


def lane_refiner_stack(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    """Folded refiner chain for wide channels, one Kernel I launch a block."""
    for blk in blocks:
        x = lane_refiner_block(x, blk)
    return x
