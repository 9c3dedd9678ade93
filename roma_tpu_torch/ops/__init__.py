from .attention import attention_packed, sdpa, sdpa_reference
from .cls_to_flow import cls_to_flow_refine
from .coords import (
    batched_grid,
    normalized_grid,
    to_normalized_coords,
    to_pixel_coords,
    warp_to_pixel_coords,
)
from .depthwise import depthwise_bn_relu, depthwise_bn_relu_reference, padded_width, wide_stack
from .fused_attention import (
    attention_backward_reference,
    attention_packed_reference,
    fused_attention,
    fused_attention_backward,
    fused_attention_packed,
)
from .grid_sample import grid_sample
from .interpolate import interpolate
from .kde import kde
from .local_corr import corr_volume, local_correlation, local_correlation_reference
from .onehot_dots import (
    onehot_dot,
    onehot_dot_2bf16,
    onehot_dot_f32,
    onehot_dot_reference,
    window_sum,
    window_sum_reference,
)
from .refiner_stack import (
    fold_block,
    fold_refiner,
    fused_refiner_stack,
    fused_refiner_stack_packed,
    refiner_stack_reference,
)
from .resize import resize_normalize, resize_normalize_reference
from .sampling import balanced_sample, multinomial_no_replacement
from .tile_window import WarpSpec, warp_tiles, warp_tiles_reference, warp_tiles_v1, windowed_warp
from .warp_sample import warp_sample, warp_sample_reference
from .wide_refiner import hcw_refiner_block, lane_refiner_block, wide_refiner_stack_reference
from .window_util import compact_miss, compact_miss_reference

# the hand-written kernels' wrappers, each with a ``launches`` count
KERNEL_WRAPPERS = (fused_attention_packed, local_correlation, warp_sample, fused_refiner_stack,
                   fused_attention_backward, fused_attention, compact_miss, warp_tiles,
                   warp_tiles_v1, fused_refiner_stack_packed, lane_refiner_block, hcw_refiner_block,
                   onehot_dot, window_sum, resize_normalize, depthwise_bn_relu)

__all__ = [
    "KERNEL_WRAPPERS",
    "WarpSpec",
    "attention_backward_reference",
    "attention_packed",
    "attention_packed_reference",
    "balanced_sample",
    "batched_grid",
    "cls_to_flow_refine",
    "compact_miss",
    "compact_miss_reference",
    "corr_volume",
    "depthwise_bn_relu",
    "depthwise_bn_relu_reference",
    "fold_block",
    "fold_refiner",
    "fused_attention",
    "fused_attention_backward",
    "fused_attention_packed",
    "fused_refiner_stack",
    "fused_refiner_stack_packed",
    "grid_sample",
    "hcw_refiner_block",
    "interpolate",
    "kde",
    "lane_refiner_block",
    "local_correlation",
    "local_correlation_reference",
    "multinomial_no_replacement",
    "normalized_grid",
    "onehot_dot",
    "onehot_dot_2bf16",
    "onehot_dot_f32",
    "onehot_dot_reference",
    "padded_width",
    "refiner_stack_reference",
    "resize_normalize",
    "resize_normalize_reference",
    "sdpa",
    "sdpa_reference",
    "to_normalized_coords",
    "to_pixel_coords",
    "warp_sample",
    "warp_sample_reference",
    "warp_tiles",
    "warp_tiles_reference",
    "warp_tiles_v1",
    "warp_to_pixel_coords",
    "wide_refiner_stack_reference",
    "wide_stack",
    "window_sum",
    "window_sum_reference",
    "windowed_warp",
]
