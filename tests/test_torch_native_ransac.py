"""The port's native RANSAC loader (roma_tpu_torch/native.py) against the JAX
package's (roma_tpu.native) on the same inputs: one source and one seed, so
R, t, H and the inlier masks must be bitwise equal. The cases are those of
tests/test_native_ransac.py (synthetic with outliers, planar, minimal counts
5, 6 and 8, the seed sweep). The port builds into build/roma_tpu_torch/,
never into native/ransac/, and raises when the build fails."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from roma_tpu import native as jax_native
from roma_tpu_torch import native

ROOT = Path(__file__).resolve().parent.parent
K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])


def _rot_y(ang):
    return np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])


def _project(X, R, t, K):
    X2 = X @ R.T + t
    return ((X / X[:, 2:]) @ K.T)[:, :2], ((X2 / X2[:, 2:]) @ K.T)[:, :2]


def _synthetic(n=300, outlier_frac=0.3, seed=0):
    rs = np.random.RandomState(seed)
    X = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n), rs.uniform(4, 10, n)], -1)
    p1, p2 = _project(X, _rot_y(0.15), np.array([0.5, 0.1, 0.05]), K)
    k1, k2 = p1 + rs.randn(n, 2) * 0.3, p2 + rs.randn(n, 2) * 0.3
    n_out = int(n * outlier_frac)
    k2[:n_out] = rs.uniform(0, 640, (n_out, 2))
    return k1, k2, K, K, 1.0, 10000


def _planar():
    rs = np.random.RandomState(3)
    n = 100
    xy = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n)], -1)
    X = np.concatenate([xy, (5 + 0.3 * xy[:, 0] + 0.2 * xy[:, 1])[:, None]], -1)
    p1, p2 = _project(X, _rot_y(0.12), np.array([0.4, 0.15, 0.05]), K)
    return p1 + rs.randn(n, 2) * 0.1, p2 + rs.randn(n, 2) * 0.1, K, K, 1.0, 10000


def _minimal(n):
    rs = np.random.RandomState(4)
    X = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n), rs.uniform(4, 10, n)], -1)
    p1, p2 = _project(X, _rot_y(0.2), np.array([0.5, 0.2, 0.1]), K)
    return p1, p2, K, K, 0.5, 200


def _border_outliers():
    """3000 near-exact matches, 25% border-pinned outliers, a wide camera
    (the dense-match failure mode of test_pose_deterministic_and_flyer_free...)."""
    rs = np.random.RandomState(11)
    n = 3000
    K2 = np.array([[820.0, 0, 432], [0, 820.0, 432], [0, 0, 1]])
    X = np.stack([rs.uniform(-3, 3, n), rs.uniform(-3, 3, n), rs.uniform(4, 9, n)], -1)
    p1, p2 = _project(X, _rot_y(0.06), np.array([0.8, 0.25, 0.1]), K2)
    k1, k2 = p1 + rs.randn(n, 2) * 0.1, p2 + rs.randn(n, 2) * 0.1
    k2[: n // 4, 0] = rs.uniform(0, 20, n // 4)
    k2[: n // 4, 1] = rs.uniform(0, 864, n // 4)
    return k1, k2, K2, K2, 0.5, 10000


POSE_CASES = {"synthetic": _synthetic, "planar": _planar, "minimal 5": lambda: _minimal(5),
              "minimal 6": lambda: _minimal(6), "minimal 8": lambda: _minimal(8),
              "border outliers": _border_outliers}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", list(POSE_CASES))
def test_relative_pose_bitwise_equal_to_jax_loader(case, seed):
    k1, k2, K1, K2, thresh, iters = POSE_CASES[case]()
    got = native.estimate_relative_pose(k1, k2, K1, K2, threshold=thresh, max_iters=iters, seed=seed)
    ref = jax_native.estimate_relative_pose(k1, k2, K1, K2, threshold=thresh, max_iters=iters, seed=seed)
    assert got is not None and ref is not None
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    R, t, inl = got
    assert inl.dtype == bool and inl.shape == (len(k1),) and inl.any()
    if case.startswith("minimal"):
        assert np.count_nonzero(inl) == len(k1)


@pytest.mark.parametrize("seed", [0, 5])
def test_homography_bitwise_equal_to_jax_loader(seed):
    rs = np.random.RandomState(1)
    H_gt = np.array([[1.1, 0.05, 20], [-0.03, 0.95, -10], [1e-4, -5e-5, 1.0]])
    p1 = rs.uniform(0, 500, (200, 2))
    p2h = np.concatenate([p1, np.ones((200, 1))], -1) @ H_gt.T
    p2 = p2h[:, :2] / p2h[:, 2:] + rs.randn(200, 2) * 0.5
    p2[:40] = rs.uniform(0, 500, (40, 2))
    got = native.estimate_homography(p1, p2, threshold=3.0, seed=seed)
    ref = jax_native.estimate_homography(p1, p2, threshold=3.0, seed=seed)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert np.count_nonzero(got[1]) > 120


def test_too_few_points_give_none_on_both_loaders():
    k1, k2, K1, K2, thresh, _ = _minimal(4)
    assert native.estimate_relative_pose(k1, k2, K1, K2, threshold=thresh) is None
    assert jax_native.estimate_relative_pose(k1, k2, K1, K2, threshold=thresh) is None
    assert native.estimate_homography(k1[:3], k2[:3]) is None


def test_pose_with_an_empty_mask_is_no_pose(monkeypatch):
    """The library's count decides nothing beyond "none" (<= 0): a positive
    count beside an empty mask is no pose (ransac.cpp:1101,1107)."""
    class Lib:
        @staticmethod
        def estimate_relative_pose(*args):
            return 7  # writes no inlier

    monkeypatch.setattr(native, "load", lambda: Lib)
    k1, k2, K1, K2, thresh, _ = _minimal(8)
    assert native.estimate_relative_pose(k1, k2, K1, K2) is None


def test_builds_under_build_dir_and_leaves_native_untouched():
    """Only the JAX loader's own make output may appear in native/ransac/
    (another test process may run it); the port adds nothing there."""
    src_dir = ROOT / "native" / "ransac"
    sources = lambda: sorted((p.name, p.stat().st_mtime_ns) for p in src_dir.iterdir()
                             if p.name != "libroma_ransac.so")
    before = sources()
    code = ("import roma_tpu_torch.native as n; p = n.build(); assert n.available(); print(p)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = Path(res.stdout.strip().splitlines()[-1])
    assert lib.parent == ROOT / "build" / "roma_tpu_torch" and lib.exists()
    assert lib.name.startswith("libroma_ransac_")
    assert sources() == before == [(n, m) for n, m in before if n in ("Makefile", "ransac.cpp")]


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ransac.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    assert not native.available()
    assert not any((tmp_path / "build").glob("*.so"))
