"""Mega-1500 pose benchmark on the native RANSAC library (counterpart of
roma_tpu/benchmarks/mega1500_native.py), the poselib path's equivalent
(reference romatch/benchmarks/megadepth_pose_estimation_benchmark_poselib.py:
11-116, with its ``num_ransac_iter`` / ``test_every`` knobs). The loader and
engine of mega1500; only the estimator differs.
"""
from __future__ import annotations

from .mega1500 import MEGA_1500_SCENES, load_megadepth_pairs
from .pose_bench import native_estimator, run_pose_benchmark


class Mega1500NativePoseBenchmark:
    def __init__(self, data_root="data/megadepth", scene_names=None, num_ransac_iter: int = 5,
                 test_every: int = 1):
        self.data_root = data_root
        self.scene_names = scene_names or MEGA_1500_SCENES
        self.num_ransac_iter = num_ransac_iter
        self.test_every = test_every

    def benchmark(self, model, model_name=None, batch_size: int | None = None, seed: int = 0):
        pairs = load_megadepth_pairs(self.data_root, self.scene_names, test_every=self.test_every)
        summary = run_pose_benchmark(model, pairs, estimator=native_estimator, repeats=self.num_ransac_iter,
                                     batch_size=batch_size, seed=seed)
        return {k: summary[k] for k in ("auc_5", "auc_10", "auc_20")}
