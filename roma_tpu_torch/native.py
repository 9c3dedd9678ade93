"""ctypes bindings to the native two-view geometry library,
``native/ransac/ransac.cpp`` (counterpart of roma_tpu/native/__init__.py):
the essential-matrix and homography RANSAC of the pose and homography
benchmarks.

The source is compiled at first use with the flags of its Makefile
(``g++ -O3 -fPIC -std=c++17 -shared``) into ``build/roma_tpu_torch/`` at the
repository root, keyed by a hash of the source and the flags, and written
under a per-process temporary name and renamed, so concurrent processes can
build at once; ``native/ransac/`` is only read. A failed build raises: no
caller falls back to OpenCV (``benchmarks.pose_bench.cv2_estimator`` is a
separate choice).

The inlier mask is returned as the library writes it, and only the mask
counts: the library's return value can exceed the mask's popcount
(ransac.cpp:1101,1107), so it decides nothing beyond "no model" (<= 0), and
a model whose mask holds no inlier is no model either.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "ransac" / "ransac.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "roma_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libroma_ransac_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``ransac.cpp`` into :func:`library_path`; a no-op when the
    library exists. Raises RuntimeError when the compiler fails or is
    missing."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the native RANSAC library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}_{threading.get_ident()}.so")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded library, built first if needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            dp, u8p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8)
            lib.estimate_relative_pose.restype = ctypes.c_int
            lib.estimate_relative_pose.argtypes = [dp, dp, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                                                   ctypes.c_uint64, dp, dp, u8p]
            lib.estimate_homography.restype = ctypes.c_int
            lib.estimate_homography.argtypes = [dp, dp, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                                                ctypes.c_uint64, dp, u8p]
            _lib = lib
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def estimate_relative_pose(kpts1, kpts2, K1, K2, threshold: float = 0.5, max_iters: int = 10000, seed: int = 0):
    """Calibrated relative pose by the native essential RANSAC.

    Keypoints in pixels, ``threshold`` in pixels (normalized by the mean
    focal of both cameras, as the reference's utils.py:85-87). Returns
    (R (3, 3), t (3,), inliers (n,) bool), or None when no pose was found
    (the mask holds no inlier)."""
    lib = load()
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    x1 = np.ascontiguousarray((np.asarray(kpts1) - K1[None, :2, 2]) @ np.linalg.inv(K1[:2, :2]).T, np.float64)
    x2 = np.ascontiguousarray((np.asarray(kpts2) - K2[None, :2, 2]) @ np.linalg.inv(K2[:2, :2]).T, np.float64)
    norm_thresh = threshold / (np.mean(np.abs(K1[:2, :2])) + np.mean(np.abs(K2[:2, :2])))
    n = len(x1)
    R, t, inl = np.zeros((3, 3), np.float64), np.zeros(3, np.float64), np.zeros(n, np.uint8)
    cnt = lib.estimate_relative_pose(_dptr(x1), _dptr(x2), n, float(norm_thresh), int(max_iters), int(seed),
                                     _dptr(R), _dptr(t), _u8ptr(inl))
    mask = inl.astype(bool)
    if cnt <= 0 or not mask.any():
        return None
    return R, t, mask


def estimate_homography(kpts1, kpts2, threshold: float = 3.0, max_iters: int = 10000, seed: int = 0):
    """Homography RANSAC in pixel coordinates. Returns (H (3, 3), inliers
    (n,) bool), or None when no homography was found."""
    lib = load()
    x1, x2 = np.ascontiguousarray(kpts1, np.float64), np.ascontiguousarray(kpts2, np.float64)
    n = len(x1)
    H, inl = np.zeros((3, 3), np.float64), np.zeros(n, np.uint8)
    cnt = lib.estimate_homography(_dptr(x1), _dptr(x2), n, float(threshold), int(max_iters), int(seed),
                                  _dptr(H), _u8ptr(inl))
    mask = inl.astype(bool)
    if cnt <= 0 or not mask.any():
        return None
    return H, mask
