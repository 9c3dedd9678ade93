"""The port's benchmarks (roma_tpu_torch/benchmarks/) against the JAX
package's (roma_tpu/benchmarks/), on the CPU.

* Every function of pose.py on the same inputs, to 1e-12 (the OpenCV
  estimators are deterministic, so they agree bit for bit), and pose_auc's
  extremes; PoseErrors.summary equal.
* The Mega-1500, ScanNet-1500 and HPatches loaders on the same files (a
  Mega-1500 scene .npz written as tests/test_pose_bench.py does, and the
  miniature trees of tests/fixtures_realformat.py): every field equal.
* The engines on a stub matcher that returns the exact warp of a synthetic
  two-view scene and samples one fixed match set whatever the key, so the
  sampling keys (fold_in on one side, repeat_key on the other) play no
  part: run_pose_benchmark with the cv2 and native estimators (and
  ScanNet's offset and doubled final repeat), the Mega-1500 / native /
  ScanNet benchmark classes and HpatchesHomogBenchmark give JAX's
  summaries and per-repeat errors to 1e-9.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from PIL import Image

import roma_tpu.benchmarks as jb
import roma_tpu_torch.benchmarks as tb
from roma_tpu.benchmarks import hpatches as j_hp, pose as j_pose, pose_bench as j_pb, scannet as j_sn
from roma_tpu_torch.benchmarks import hpatches as t_hp, pose as t_pose, pose_bench as t_pb, scannet as t_sn
from roma_tpu_torch.benchmarks.mega1500_native import Mega1500NativePoseBenchmark
from roma_tpu_torch.tools import crossimpl

from fixtures_realformat import make_hpatches_fixture, make_scannet1500_fixture

EXACT = 1e-12
SUMMARY_TOL = 1e-9


def _two_view(n=500, seed=0, noise=0.3):
    rs = np.random.RandomState(seed)
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    X = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n), rs.uniform(4, 10, n)], -1)
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.5, 0.1, 0.05])
    X2 = X @ R.T + t
    p1 = ((X / X[:, 2:]) @ K.T)[:, :2] + rs.randn(n, 2) * noise
    p2 = ((X2 / X2[:, 2:]) @ K.T)[:, :2] + rs.randn(n, 2) * noise
    p2[: n // 5] = rs.uniform(0, 640, (n // 5, 2))
    return p1, p2, K, R, t


def _close(a, b, tol=EXACT):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype == bool:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _pose_cases():
    p1, p2, K, R, t = _two_view()
    rs = np.random.RandomState(1)
    T = np.concatenate([R, t[:, None]], -1)
    F = rs.randn(3, 3)
    return {
        "estimate_pose": ((p1, p2, K, K, 0.5 / 600), {}),
        "estimate_pose too few": ((p1[:4], p2[:4], K, K, 0.5 / 600), {}),
        "estimate_pose_uncalibrated": ((p1, p2, K, K, 1.0), {}),
        "compute_pose_error": ((T, R @ R, t + 0.1), {}),
        "compute_pose_error exact": ((T, R, -t), {}),
        "compute_relative_pose": ((R, t, R.T, -t), {}),
        "angle_error_mat": ((R, R.T), {}),
        "angle_error_vec": ((t, t[::-1]), {}),
        "pose_auc mixed": ((np.array([0.5, 3.0, 7.0, 12.0, 90.0]), [5, 10, 20]), {}),
        "pose_auc all zero": ((np.zeros(7), [5, 10, 20]), {}),
        "pose_auc all failed": ((np.full(4, 90.0), [5, 10, 20]), {}),
        "pose_auc at the thresholds": ((np.array([5.0, 10.0, 20.0]), [5, 10, 20]), {}),
        "scale_intrinsics": ((K, (2.0, 0.5)), {}),
        "rotate_intrinsic": ((K, 3), {}),
        "signed_point_line_distance": ((p1, rs.randn(len(p1), 3)), {}),
        "signed_left_to_right_epipolar_distance": ((p1, p2, F), {}),
        "rotate_pose_inplane": ((np.eye(4, dtype=np.float32), 1), {}),
    }


@pytest.mark.parametrize("case", list(_pose_cases()))
def test_pose_functions_equal_jax(case):
    args, kw = _pose_cases()[case]
    name = case.split(" ")[0]
    got, ref = getattr(t_pose, name)(*args, **kw), getattr(j_pose, name)(*args, **kw)
    _close(got, ref)
    if case == "pose_auc all zero":
        assert got == [1.0, 1.0, 1.0]
    if case == "pose_auc all failed":
        assert got == [0.0, 0.0, 0.0]


def test_pose_errors_summary_equal():
    rs = np.random.RandomState(2)
    t_err, j_err = t_pb.PoseErrors(), j_pb.PoseErrors()
    for e_t, e_R in zip(rs.exponential(6.0, 40), rs.exponential(4.0, 40)):
        t_err.add(e_t, e_R)
        j_err.add(e_t, e_R)
    t_err.add(90.0, 90.0)
    j_err.add(90.0, 90.0)
    assert t_err.summary() == j_err.summary()
    assert t_err.e_pose == j_err.e_pose


def test_package_exports_match_jax():
    assert set(tb.__all__) == set(jb.__all__) - {"MegadepthDenseBenchmark"}
    assert tb.MEGA_1500_SCENES == jb.MEGA_1500_SCENES and tb.MEGA_8_SCENES == jb.MEGA_8_SCENES
    assert t_hp.IGNORE_SEQS == j_hp.IGNORE_SEQS
    assert (t_hp.PIXEL_OFFSET, t_hp.NORM_SHORT_SIDE) == (j_hp.PIXEL_OFFSET, j_hp.NORM_SHORT_SIDE) == (0.5, 480.0)
    assert t_sn.PROTOCOL_SHORT_SIDE == j_sn.PROTOCOL_SHORT_SIDE == 480


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------


def _same_pairs(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert type(g).__name__ == type(r).__name__
        gd, rd = vars(g), vars(r)
        assert gd.keys() == rd.keys()
        for k in gd:
            if isinstance(rd[k], np.ndarray):
                assert gd[k].dtype == rd[k].dtype and np.array_equal(gd[k], rd[k]), k
            else:
                assert gd[k] == rd[k], k


@pytest.fixture(scope="module")
def mega_scene(tmp_path_factory):
    """A Mega-1500 scene .npz and its images, as tests/test_pose_bench.py
    writes them (two pairs, images of other sizes)."""
    root = tmp_path_factory.mktemp("mega")
    rs = np.random.RandomState(0)
    os.makedirs(root / "imgs")
    paths = []
    for i, (w, h) in enumerate([(400, 300), (600, 240), (320, 480)]):
        p = f"imgs/{i}.jpg"
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(root / p)
        paths.append(p)
    K = np.array([[100.0, 0, 200], [0, 100.0, 150], [0, 0, 1]])
    T = [np.eye(4) for _ in range(3)]
    T[1][:3, 3] = [1, 0, 0]
    T[2][:3, :3] = crossimpl.make_scene(1, (8, 8)).R
    T[2][:3, 3] = [0.2, -0.1, 0.3]
    np.savez(root / "scene.npz", pair_infos=np.array([((0, 1), 0.5, None), ((2, 0), 0.3, None)], dtype=object),
             intrinsics=np.stack([K, 1.1 * K, 0.9 * K]), poses=np.stack(T), image_paths=np.array(paths))
    return str(root)


@pytest.fixture(scope="module")
def scannet1500(tmp_path_factory):
    return make_scannet1500_fixture(tmp_path_factory.mktemp("scannet1500"))


@pytest.fixture(scope="module")
def hpatches(tmp_path_factory):
    return make_hpatches_fixture(tmp_path_factory.mktemp("hpatches"))


@pytest.mark.parametrize("test_every", [1, 2])
def test_megadepth_loader_equals_jax(mega_scene, test_every):
    _same_pairs(tb.load_megadepth_pairs(mega_scene, ["scene.npz"], test_every),
                jb.load_megadepth_pairs(mega_scene, ["scene.npz"], test_every))


@pytest.mark.parametrize("seed", [0, 3])
def test_scannet_loader_equals_jax(scannet1500, seed):
    root, _ = scannet1500
    _same_pairs(t_sn.load_scannet_pairs(root, seed), j_sn.load_scannet_pairs(root, seed))


def test_hpatches_loader_equals_jax(hpatches):
    seqs = os.path.join(hpatches[0], "hpatches-sequences-release")
    _same_pairs(t_hp.load_hpatches_pairs(seqs), j_hp.load_hpatches_pairs(seqs))
    pair = t_hp.load_hpatches_pairs(seqs)[3]
    H = pair.H_gt @ np.array([[1.0, 0.01, 2.0], [0, 1, -1.0], [0, 0, 1]])
    assert t_hp.corner_warp_error(H, pair) == j_hp.corner_warp_error(H, pair)


# --------------------------------------------------------------------------
# engines on a deterministic stub
# --------------------------------------------------------------------------


class ExactStub:
    """The exact warp of a synthetic scene (crossimpl's ray-cast geometry) at
    the pair's protocol size, for every pair; ``sample`` gives one fixed set
    of matches whatever the key; to-pixel in float64 NumPy, which both
    engines take as they are."""

    def __init__(self, n_grid=48, offset=0.0):
        self.n_grid, self.offset = n_grid, offset

    def match(self, im_A, im_B):
        return im_A, im_B

    def sample(self, warp, certainty, num, key=None):
        g = np.linspace(-0.9, 0.9, self.n_grid)
        pts = np.stack(np.meshgrid(g, g, indexing="xy"), -1).reshape(-1, 2)
        scene = crossimpl.make_scene(2, (864, 864))
        w = np.concatenate([pts, crossimpl.gt_warp(scene, pts, "AtoB")], -1)
        idx = np.random.default_rng(7).choice(len(w), size=num, replace=True)
        return w[idx], np.ones(num)

    def to_pixel_coordinates(self, coords, H_A, W_A, H_B=None, W_B=None):
        tp = lambda c, h, w: np.stack((w / 2 * (c[..., 0] + 1), h / 2 * (c[..., 1] + 1)), axis=-1) + self.offset
        return tp(coords[..., :2], H_A, W_A), tp(coords[..., 2:], H_B, W_B)


def _scene_pairs(cls, n=2):
    s = crossimpl.make_scene(2, (864, 864))
    return [cls(im_A=f"a{i}", im_B=f"b{i}", K1=s.K1, K2=s.K2, R=s.R, t=s.t, hw_A=(864, 864), hw_B=(864, 864))
            for i in range(n)]


def _same_summary(got, ref):
    (gs, ge), (rs_, re) = got, ref
    assert gs.keys() == rs_.keys()
    for k in gs:
        assert abs(gs[k] - rs_[k]) <= SUMMARY_TOL, (k, gs[k], rs_[k])
    np.testing.assert_allclose(ge, re, rtol=0, atol=SUMMARY_TOL)


@pytest.mark.parametrize("estimator", ["cv2", "native"])
@pytest.mark.parametrize("scannet", [False, True], ids=["mega", "scannet"])
def test_run_pose_benchmark_equals_jax_on_a_stub(estimator, scannet):
    kw = dict(repeats=3, sample_n=400, seed=5, progress=False, return_errors=True)
    if scannet:  # the protocol's offset and doubled final repeat
        kw.update(pixel_offset=0.5, double_final_repeat=True)
    stub = ExactStub(offset=0.5 if scannet else 0.0)
    got = t_pb.run_pose_benchmark(stub, _scene_pairs(t_pb.PosePair),
                                  estimator=getattr(t_pb, f"{estimator}_estimator"), **kw)
    ref = j_pb.run_pose_benchmark(stub, _scene_pairs(j_pb.PosePair),
                                  estimator=getattr(j_pb, f"{estimator}_estimator"), **kw)
    _same_summary(got, ref)
    assert len(got[1]) == 2 * (3 + scannet)
    assert got[0]["auc_20"] > 0.9


class PathStub(ExactStub):
    """The stub for the benchmark classes: ``match`` looks the pair up by
    its path, ``sample`` gives one fixed set of exact matches of that
    pair's GT pose (points at depths 4-10 before camera A)."""

    def __init__(self, pairs, offset=0.0):
        self.table, self.offset = {p.im_A: p for p in pairs}, offset

    def match(self, im_A, im_B):
        return self.table[im_A], None

    def sample(self, pair, certainty, num, key=None):
        rs = np.random.default_rng(7)
        (h, w), (h2, w2) = pair.hw_A, pair.hw_B
        K1, K2 = pair.K1[:3, :3], pair.K2[:3, :3]
        u, v, z = rs.uniform(0, w, num), rs.uniform(0, h, num), rs.uniform(4, 10, num)
        X = np.stack([(u - K1[0, 2]) / K1[0, 0] * z, (v - K1[1, 2]) / K1[1, 1] * z, z], -1)
        X2 = X @ pair.R.T + pair.t
        uv = (X2 / X2[:, 2:]) @ K2.T
        return np.stack([2 * u / w - 1, 2 * v / h - 1, 2 * uv[:, 0] / w2 - 1, 2 * uv[:, 1] / h2 - 1], -1), None


def test_benchmark_classes_equal_jax(mega_scene, scannet1500):
    """The Mega-1500 (cv2), Mega-1500 native and ScanNet classes over their
    loaders: the port's summaries are JAX's, and the exact matches recover
    the poses."""
    from roma_tpu.benchmarks.mega1500_native import Mega1500NativePoseBenchmark as JaxNative

    stub = PathStub(tb.load_megadepth_pairs(mega_scene, ["scene.npz"]))
    got = tb.MegaDepthPoseEstimationBenchmark(mega_scene, ["scene.npz"]).benchmark(stub, num_ransac_runs=2)
    ref = jb.MegaDepthPoseEstimationBenchmark(mega_scene, ["scene.npz"]).benchmark(stub, num_ransac_runs=2)
    _same_summary((got, []), (ref, []))
    assert got["auc_20"] > 0.9
    got = Mega1500NativePoseBenchmark(mega_scene, ["scene.npz"], num_ransac_iter=2).benchmark(stub)
    ref = JaxNative(mega_scene, ["scene.npz"], num_ransac_iter=2).benchmark(stub)
    assert got.keys() == ref.keys() == {"auc_5", "auc_10", "auc_20"}
    _same_summary((got, []), (ref, []))
    root, _ = scannet1500
    stub = PathStub(t_sn.load_scannet_pairs(root), offset=0.5)
    got, ref = t_sn.ScanNetBenchmark(root).benchmark(stub), j_sn.ScanNetBenchmark(root).benchmark(stub)
    _same_summary((got, []), (ref, []))
    assert got["auc_20"] > 0.9


class HomogStub:
    """Matches that satisfy pix_B = H(pix_A) in HPatches' corner convention,
    one fixed set whatever the key (tests/test_bench_loader_fixtures.py's
    oracle), plus a torch-tensor variant: the port takes tensors too."""

    def __init__(self, truth, tensors=False):
        self.truth, self.tensors = truth, tensors

    def match(self, im_A, im_B):
        seq = os.path.basename(os.path.dirname(im_A))
        idx = int(os.path.splitext(os.path.basename(im_B))[0])
        H, (w1, h1), (w2, h2) = self.truth[(seq, idx)]
        uu, vv = np.meshgrid(np.linspace(0, w1 - 1, 48), np.linspace(0, h1 - 1, 36), indexing="xy")
        pts = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ H.T
        ub, vb = pts[..., 0] / pts[..., 2], pts[..., 1] / pts[..., 2]
        warp = np.stack([2 * (uu + 0.5) / w1 - 1, 2 * (vv + 0.5) / h1 - 1, 2 * (ub + 0.5) / w2 - 1,
                         2 * (vb + 0.5) / h2 - 1], axis=-1)
        # a few outliers, so RANSAC has work to do
        warp[::7, ::5, 2:] = np.random.default_rng(1).uniform(-1, 1, warp[::7, ::5, 2:].shape)
        return warp, np.ones(warp.shape[:2])

    def sample(self, warp, cert, num, key=None):
        w = warp.reshape(-1, 4)
        out = w[np.random.default_rng(0).choice(len(w), size=num, replace=True)]
        return (torch.from_numpy(out) if self.tensors else out), None


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
def test_hpatches_benchmark_equals_jax(hpatches, tensors):
    root, truth = hpatches
    got = t_hp.HpatchesHomogBenchmark(root).benchmark(HomogStub(truth, tensors), sample_n=512)
    ref = j_hp.HpatchesHomogBenchmark(root).benchmark(HomogStub(truth), sample_n=512)
    assert got.keys() == ref.keys()
    for k in got:
        assert abs(got[k] - ref[k]) <= SUMMARY_TOL, (k, got[k], ref[k])
    assert got["hpatches_homog_auc_10"] > 0.9


def test_repeat_keys_are_distinct_and_stable():
    keys = {t_pb.repeat_key(s, i, r) for s in range(3) for i in range(20) for r in range(5)}
    assert len(keys) == 300
    assert t_pb.repeat_key(0, 4, 2) == t_pb.repeat_key(0, 4, 2)
    assert all(0 <= k < 2**32 for k in keys)


def test_keypoints_leave_the_device_as_float64():
    k = torch.tensor([[1.5, 2.25]], dtype=torch.float32)
    out = t_pb.to_host(k)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64 and np.array_equal(out, [[1.5, 2.25]])
