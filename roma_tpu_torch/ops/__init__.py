from .cls_to_flow import cls_to_flow_refine
from .coords import normalized_grid
from .fused_attention import attention_packed_reference, fused_attention_packed
from .grid_sample import grid_sample
from .interpolate import interpolate
from .kde import kde
from .local_corr import local_correlation, local_correlation_reference
from .refiner_stack import fold_block, fold_refiner, fused_refiner_stack, refiner_stack_reference
from .sampling import balanced_sample, multinomial_no_replacement
from .warp_sample import warp_sample, warp_sample_reference

# the four hand-written kernels' wrappers, each with a ``launches`` count
KERNEL_WRAPPERS = (fused_attention_packed, local_correlation, warp_sample, fused_refiner_stack)

__all__ = [
    "KERNEL_WRAPPERS",
    "attention_packed_reference",
    "balanced_sample",
    "cls_to_flow_refine",
    "fold_block",
    "fold_refiner",
    "fused_attention_packed",
    "fused_refiner_stack",
    "grid_sample",
    "interpolate",
    "kde",
    "local_correlation",
    "local_correlation_reference",
    "multinomial_no_replacement",
    "normalized_grid",
    "refiner_stack_reference",
    "warp_sample",
    "warp_sample_reference",
]
