"""The pose and homography benchmarks (counterpart of
roma_tpu/benchmarks/): Mega-1500 / Mega-8-scenes, Mega-1500 on the native
RANSAC, ScanNet-1500 and HPatches, over a shared engine (``pose_bench``),
and the MegaDepth dense-warp benchmark (EPE, PCK).
Imports NumPy and PIL only; OpenCV and tqdm are imported by the functions
that use them."""
from .hpatches import HpatchesHomogBenchmark
from .mega1500 import (
    MEGA_8_SCENES,
    MEGA_1500_SCENES,
    MegaDepthPoseEstimationBenchmark,
    load_megadepth_pairs,
)
from .mega1500_native import Mega1500NativePoseBenchmark
from .mega_dense import MegadepthDenseBenchmark
from .pose import (
    compute_pose_error,
    compute_relative_pose,
    estimate_pose,
    estimate_pose_uncalibrated,
    pose_auc,
    signed_left_to_right_epipolar_distance,
    signed_point_line_distance,
)
from .pose_bench import (
    PosePair,
    cv2_estimator,
    match_pairs_batched,
    native_estimator,
    run_pose_benchmark,
)
from .scannet import ScanNetBenchmark

__all__ = [
    "HpatchesHomogBenchmark",
    "Mega1500NativePoseBenchmark",
    "MEGA_8_SCENES",
    "MEGA_1500_SCENES",
    "MegaDepthPoseEstimationBenchmark",
    "MegadepthDenseBenchmark",
    "PosePair",
    "ScanNetBenchmark",
    "cv2_estimator",
    "load_megadepth_pairs",
    "match_pairs_batched",
    "native_estimator",
    "run_pose_benchmark",
    "compute_pose_error",
    "compute_relative_pose",
    "estimate_pose",
    "estimate_pose_uncalibrated",
    "pose_auc",
]
