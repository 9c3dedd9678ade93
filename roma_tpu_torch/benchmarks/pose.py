"""Two-view pose estimation and its error metrics, on the host (counterpart
of roma_tpu/benchmarks/pose.py; reference romatch/utils/utils.py:30-147,
498-625). NumPy only; OpenCV is imported inside the two estimators that
use it.
"""
from __future__ import annotations

import numpy as np


def _normalize(kpts, K):
    return (np.linalg.inv(K[:2, :2]) @ (kpts - K[None, :2, 2]).T).T


def _best_pose(cv2, E, kpts0, kpts1, mask):
    """The decomposition of E (one or more stacked 3x3) that recoverPose
    finds the most points in front of both cameras for."""
    ret, best = None, 0
    for _E in np.split(E, len(E) / 3):
        n, R, t, _ = cv2.recoverPose(_E, kpts0, kpts1, np.eye(3), 1e9, mask=mask)
        if n > best:
            best = n
            ret = (R, t, mask.ravel() > 0)
    return ret


def estimate_pose(kpts0, kpts1, K0, K1, norm_thresh, conf=0.99999):
    """Essential-matrix RANSAC + recoverPose (reference utils.py:30-51)."""
    import cv2

    if len(kpts0) < 5:
        return None
    kpts0, kpts1 = _normalize(kpts0, K0), _normalize(kpts1, K1)
    E, mask = cv2.findEssentialMat(kpts0, kpts1, np.eye(3), threshold=norm_thresh, prob=conf)
    if E is None:
        return None
    return _best_pose(cv2, E, kpts0, kpts1, mask)


def estimate_pose_uncalibrated(kpts0, kpts1, K0, K1, norm_thresh, conf=0.99999):
    """Fundamental-matrix (USAC_ACCURATE) path (reference utils.py:53-75)."""
    import cv2

    if len(kpts0) < 5:
        return None
    F, mask = cv2.findFundamentalMat(kpts0, kpts1, ransacReprojThreshold=norm_thresh, confidence=conf,
                                     method=cv2.USAC_ACCURATE, maxIters=10000)
    if F is None:
        return None
    E = K1.T @ F @ K0
    return _best_pose(cv2, E, _normalize(kpts0, K0), _normalize(kpts1, K1), mask)


def angle_error_mat(R1, R2):
    cos = (np.trace(R1.T @ R2) - 1) / 2
    return np.rad2deg(np.abs(np.arccos(np.clip(cos, -1.0, 1.0))))


def angle_error_vec(v1, v2):
    n = np.linalg.norm(v1) * np.linalg.norm(v2)
    return np.rad2deg(np.arccos(np.clip(np.dot(v1, v2) / n, -1.0, 1.0)))


def compute_pose_error(T_0to1, R, t):
    """(translation angle, rotation angle) in degrees; the translation's
    sign is free (E-estimation ambiguity)."""
    R_gt, t_gt = T_0to1[:3, :3], T_0to1[:3, 3]
    error_t = angle_error_vec(t.squeeze(), t_gt)
    error_t = np.minimum(error_t, 180 - error_t)
    return error_t, angle_error_mat(R, R_gt)


def compute_relative_pose(R1, t1, R2, t2):
    rots = R2 @ R1.T
    return rots, -rots @ t1 + t2


def pose_auc(errors, thresholds):
    """Trapezoid AUC of recall over the error threshold (reference
    utils.py:135-147)."""
    sort_idx = np.argsort(errors)
    errors = np.array(errors.copy())[sort_idx]
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(np.trapezoid(r, x=e).item() / t)
    return aucs


def scale_intrinsics(K, scales):
    return np.diag([1.0 / scales[0], 1.0 / scales[1], 1.0]) @ K


def rotate_intrinsic(K, n):
    base_rot = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]])
    return np.linalg.matrix_power(base_rot, n) @ K


def signed_point_line_distance(point, line, eps: float = 1e-9):
    """Signed distance from 2D points to lines ax + by + c = 0 (reference
    utils.py:575-597)."""
    point, line = np.asarray(point), np.asarray(line)
    numerator = line[..., 0] * point[..., 0] + line[..., 1] * point[..., 1] + line[..., 2]
    return numerator / (np.linalg.norm(line[..., :2], axis=-1) + eps)


def signed_left_to_right_epipolar_distance(pts1, pts2, Fm):
    """Distance from right-image points to the epilines of left-image
    points (reference utils.py:600-625)."""
    pts1, pts2 = np.asarray(pts1), np.asarray(pts2)
    if pts1.shape[-1] == 2:
        pts1 = np.concatenate([pts1, np.ones_like(pts1[..., :1])], axis=-1)
    return signed_point_line_distance(pts2, pts1 @ np.swapaxes(Fm, -2, -1))


def rotate_pose_inplane(i_T_w, rot):
    """``i_T_w`` turned in the image plane by (0, 270, 180, 90)[rot] degrees."""
    r = np.deg2rad((0, 270, 180, 90)[rot])
    rotation = np.array([[np.cos(r), -np.sin(r), 0.0, 0.0], [np.sin(r), np.cos(r), 0.0, 0.0],
                         [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)
    return rotation @ i_T_w
