"""The shared two-view pose-benchmark engine (counterpart of
roma_tpu/benchmarks/pose_bench.py).

Every pose benchmark (Mega-1500 / Mega-8-scenes, the native-RANSAC variant,
ScanNet-1500) is one experiment with its own pair loader and estimator:

    pairs -> dense match -> N x { sample, to-pixel, RANSAC, pose error }
          -> pooled AUC@5/10/20 + mAP

The protocol constants are the reference's
(romatch/benchmarks/megadepth_pose_estimation_benchmark.py:59-87,
scannet_benchmark.py:59-125): 5000 samples, 5 repeats, thresholds
(5, 10, 20), a 0.5 px threshold normalized by the mean focal length, and an
error of 90 degrees when the estimator fails.

The benchmark owns its randomness: ``seed`` drives the keypoint permutation
(a NumPy generator) and the sampling, whose draw for pair ``i``, repeat
``rep`` is seeded with :func:`repeat_key` ``(seed, i, rep)``, passed to
``model.sample(key=int)``. The draws are not the JAX package's (its keys
are ``fold_in`` of a PRNG key), and a CUDA generator draws otherwise than a
CPU one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator

import numpy as np

from .pose import compute_pose_error, estimate_pose, pose_auc

THRESHOLDS = (5, 10, 20)


@dataclasses.dataclass
class PosePair:
    """One evaluation pair: image paths and protocol-rescaled geometry."""

    im_A: str
    im_B: str
    K1: np.ndarray          # (3, 3), already protocol-rescaled
    K2: np.ndarray
    R: np.ndarray           # GT relative rotation (3, 3)
    t: np.ndarray           # GT relative translation (3,)
    hw_A: tuple[float, float]  # protocol-rescaled (h, w) for to-pixel
    hw_B: tuple[float, float]


class PoseErrors:
    """Pooled pose errors -> AUC / mAP summary."""

    def __init__(self):
        self.e_t: list[float] = []
        self.e_R: list[float] = []
        self.e_pose: list[float] = []

    def add(self, e_t: float, e_R: float):
        self.e_t.append(float(e_t))
        self.e_R.append(float(e_R))
        self.e_pose.append(float(max(e_t, e_R)))

    def summary(self, thresholds=THRESHOLDS) -> dict[str, float]:
        e = np.asarray(self.e_pose)
        auc = pose_auc(e, list(thresholds))
        acc = {th: float((e < th).mean()) for th in (5, 10, 15, 20)}
        return {
            "auc_5": auc[0],
            "auc_10": auc[1],
            "auc_20": auc[2],
            "map_5": acc[5],
            "map_10": float(np.mean([acc[5], acc[10]])),
            "map_20": float(np.mean([acc[5], acc[10], acc[15], acc[20]])),
        }


def repeat_key(seed: int, pair_index: int, rep: int) -> int:
    """The sampling seed of one (pair, repeat) of a benchmark run."""
    return int(np.random.SeedSequence([seed, pair_index, rep]).generate_state(1)[0])


def to_host(x) -> np.ndarray:
    """Keypoints as a float64 NumPy array: one copy off the device for a
    tensor."""
    if hasattr(x, "detach"):
        return x.detach().to("cpu").double().numpy()
    return np.asarray(x, np.float64)


def cv2_estimator(kpts1, kpts2, K1, K2, rep: int):
    """OpenCV 5-point essential RANSAC (reference utils.py:30-51), at 0.5 px
    normalized by the mean focal of both cameras
    (megadepth_pose_estimation_benchmark.py:76-79)."""
    norm_threshold = 0.5 / (np.mean(np.abs(K1[:2, :2])) + np.mean(np.abs(K2[:2, :2])))
    out = estimate_pose(kpts1, kpts2, K1, K2, norm_threshold, conf=0.99999)
    if out is None:
        raise RuntimeError("essential-matrix estimation failed")
    R_est, t_est, _ = out
    return R_est, t_est.reshape(3)


def native_estimator(kpts1, kpts2, K1, K2, rep: int):
    """The C++ RANSAC of native/ransac, the poselib path's equivalent
    (megadepth_pose_estimation_benchmark_poselib.py:78-84), seeded by the
    repeat."""
    from .. import native

    out = native.estimate_relative_pose(np.asarray(kpts1, np.float64), np.asarray(kpts2, np.float64),
                                        K1, K2, threshold=0.5, max_iters=10000, seed=rep)
    if out is None:
        raise RuntimeError("native pose estimation failed")
    R_est, t_est, _ = out
    return R_est, t_est.reshape(3)


def evaluate_matched_pair(
    model,
    pair: PosePair,
    warp,
    certainty,
    errors: PoseErrors,
    rng: np.random.Generator,
    estimator: Callable = cv2_estimator,
    repeats: int = 5,
    sample_n: int = 5000,
    pixel_offset: float = 0.0,
    double_final_repeat: bool = False,
    sample_key: tuple[int, int] | None = None,
):
    """Sample and estimate ``repeats`` times from one pair's dense match.

    ``sample_key``: (seed, pair index); repeat ``rep`` samples with
    ``key=repeat_key(seed, index, rep)``. ``None`` leaves the draws to the
    model's own generator."""
    (h1, w1), (h2, w2) = pair.hw_A, pair.hw_B
    e_t = e_R = 90.0
    for rep in range(repeats):
        key = None if sample_key is None else repeat_key(*sample_key, rep)
        sparse, _ = model.sample(warp, certainty, sample_n, key=key)
        kpts1, kpts2 = model.to_pixel_coordinates(sparse, h1, w1, h2, w2)
        kpts1 = to_host(kpts1) - pixel_offset
        kpts2 = to_host(kpts2) - pixel_offset
        order = rng.permutation(len(kpts1))
        kpts1, kpts2 = kpts1[order], kpts2[order]
        try:
            R_est, t_est = estimator(kpts1, kpts2, pair.K1, pair.K2, rep)
            T_est = np.concatenate((R_est, t_est[:, None]), axis=-1)
            e_t, e_R = compute_pose_error(T_est, pair.R, pair.t)
        except Exception as exc:  # estimator failure -> the protocol's largest error
            print(repr(exc))
            e_t = e_R = 90.0
        errors.add(e_t, e_R)
    if double_final_repeat:
        # ScanNet protocol quirk: the reference appends the last repeat twice
        # (scannet_benchmark.py:123-125); kept for comparable numbers
        errors.add(e_t, e_R)


def match_pairs_single(model, pairs: Iterable[PosePair]) -> Iterator[tuple[PosePair, object, object]]:
    """The reference's match phase: one pair at a time from paths."""
    for pair in pairs:
        warp, certainty = model.match(pair.im_A, pair.im_B)
        yield pair, warp, certainty


def match_pairs_batched(model, pairs: list[PosePair], batch_size: int) -> Iterator[tuple[PosePair, object, object]]:
    """The match phase through ``serving.MatchEngine``: host decode and
    resize ahead of the card, one two-pass match a batch of pairs. Metrics
    equal the single-pair protocol's up to the batch's numerics."""
    from ..serving import MatchEngine

    engine = MatchEngine(model, batch_size=batch_size)
    for pair, result in zip(pairs, engine.match_paths((p.im_A, p.im_B) for p in pairs)):
        yield pair, result.warp, result.certainty


def run_pose_benchmark(
    model,
    pairs: list[PosePair],
    estimator: Callable = cv2_estimator,
    repeats: int = 5,
    sample_n: int = 5000,
    pixel_offset: float = 0.0,
    double_final_repeat: bool = False,
    batch_size: int | None = None,
    seed: int = 0,
    progress: bool = True,
    return_errors: bool = False,
):
    """The whole benchmark; ``batch_size`` takes the batched match phase.
    Two runs over one model object give the same match sets (the
    reference's stochastic-eval caveat, README.md:149-152, without the
    statefulness). ``return_errors`` also returns the pooled per-repeat
    max(e_t, e_R) behind the summary."""
    rng = np.random.default_rng(seed)
    errors = PoseErrors()
    matched = (match_pairs_batched(model, pairs, batch_size) if batch_size is not None
               else match_pairs_single(model, pairs))
    if progress:
        from tqdm import tqdm

        matched = tqdm(matched, total=len(pairs))
    for i, (pair, warp, certainty) in enumerate(matched):
        evaluate_matched_pair(model, pair, warp, certainty, errors, rng, estimator=estimator, repeats=repeats,
                              sample_n=sample_n, pixel_offset=pixel_offset,
                              double_final_repeat=double_final_repeat, sample_key=(seed, i))
    if return_errors:
        return errors.summary(), list(errors.e_pose)
    return errors.summary()
