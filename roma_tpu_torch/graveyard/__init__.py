"""Ports of the JAX package's graveyard/ experiments: kernels that lost to
the routed paths on the TPU and stay as parity-tested records. Nothing on
the match or training path calls them.

- ``window_warp_v1``: the v1 windowed tile sampler (Kernels F and G's v1
  entry).
- ``pallas_refiner_lanemajor``: ``lane_refiner_stack``, the wide-C folded
  refiner stack on NHWC, one launch of Kernel I a block.
- ``pallas_hcw_refiner``: ``hcw_refiner_stack``, the same stack in the
  (B, H, C, W) layout, one launch of Kernel J a block.

roma_tpu_torch/tools/bench_hcw_refiner.py times the two stacks against the
model's cuDNN block stack at the released refiner shapes.
"""
