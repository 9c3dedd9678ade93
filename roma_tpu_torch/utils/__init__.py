"""Host-side image IO and profiling (counterpart of roma_tpu/utils)."""
from .image import check_not_i16, check_rgb, imagenet_normalize, load_image, prepare, to_array, to_pil
from .profiling import MetricLogger, StepTimer, annotate, trace

__all__ = [
    "check_not_i16",
    "check_rgb",
    "imagenet_normalize",
    "load_image",
    "prepare",
    "to_array",
    "to_pil",
    "MetricLogger",
    "StepTimer",
    "annotate",
    "trace",
]
