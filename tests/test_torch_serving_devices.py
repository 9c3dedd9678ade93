"""The port's MatchEngine over several devices (``devices=``, the JAX
engine's ``mesh``) on the CPU, at RoMaConfig.tiny() with the weights of
tests/torch_port_fixtures.py and images written under tmp_path: two CPU
replicas at batch 4 (two shards of 2) give the one-device engine's results
at batch 2 bit for bit, in input order, with the short last batch padded;
the first replica is the model, the second a copy with equal tensors; a
``batch_size`` that does not divide by the device count is refused; and
``run_pose_benchmark(devices=)`` gives the one-device run's summary and
keypoints exactly."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from roma_tpu_torch import MatchEngine
from roma_tpu_torch.benchmarks.pose_bench import PosePair, run_pose_benchmark
from roma_tpu_torch.models.roma import RegressionMatcher
from roma_tpu_torch.parallel import get_devices
from torch_port_fixtures import port_net, seeded_tiny_variables
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

H = W = 56
UP = (64, 64)


@pytest.fixture(scope="module")
def model():
    return RegressionMatcher(port_net(seeded_tiny_variables(0)), h=H, w=W, upsample_res=UP)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_devices")
    rs = np.random.RandomState(5)
    paths = []
    for i, (w, h) in enumerate([(100, 80), (90, 70), (64, 96), (120, 60)]):
        p = d / f"im{i}.png"
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    # 5 pairs: batches of 4 leave a short last batch of one pair
    return [(paths[i % 4], paths[(i + 1) % 4]) for i in range(5)]


@pytest.mark.parametrize("on_host", [False, True], ids=["tensors", "on_host"])
def test_two_replicas_equal_one_device_bit_for_bit(model, pairs, on_host):
    two = MatchEngine(model, batch_size=4, devices=["cpu", "cpu"])
    assert two.replicas[0] is model and two.replicas[1] is not model
    assert two.replicas[1].net is not model.net
    assert all(torch.equal(a, b) for a, b in zip(model.net.state_dict().values(),
                                                 two.replicas[1].net.state_dict().values()))
    got = list(two.match_paths(pairs, on_host=on_host))
    want = list(MatchEngine(model, batch_size=2).match_paths(pairs, on_host=on_host))
    assert [r.index for r in got] == [r.index for r in want] == list(range(len(pairs)))
    for g, w in zip(got, want):
        assert (g.im_A, g.im_B) == (w.im_A, w.im_B)
        for a, b in ((g.warp, w.warp), (g.certainty, w.certainty)):
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            assert a.shape == b.shape and torch.equal(a, b)
    assert isinstance(got[0].warp, np.ndarray) == on_host


def test_a_batch_that_does_not_divide_is_refused(model):
    with pytest.raises(ValueError, match="batch_size 3 must divide across the 2 devices"):
        MatchEngine(model, batch_size=3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="batch_size"):
        MatchEngine(model, batch_size=2, devices=[])


def test_get_devices_counts_the_cards():
    n = torch.cuda.device_count()
    if n:
        assert get_devices() == [torch.device("cuda", i) for i in range(n)]
    with pytest.raises(RuntimeError, match=f"{n + 1} CUDA devices asked for, {n} visible"):
        get_devices(n + 1)


def test_run_pose_benchmark_over_devices_equals_one_device(model, pairs):
    """A recording estimator (the pose is a function of the keypoints) in
    place of RANSAC: the two runs must see the same keypoints."""
    rs = np.random.RandomState(6)
    K = np.array([[60.0, 0, 28], [0, 60.0, 28], [0, 0, 1]])
    poses = [PosePair(im_A=a, im_B=b, K1=K, K2=K, R=np.eye(3), t=rs.randn(3), hw_A=(80.0, 100.0), hw_B=(70.0, 90.0))
             for a, b in pairs[:3]]

    def run(**kw):
        seen = []

        def estimator(k1, k2, K1, K2, rep):
            seen.append((np.asarray(k1).copy(), np.asarray(k2).copy()))
            t = np.concatenate([np.mean(k2 - k1, 0), [1.0]])
            return np.eye(3), t / np.linalg.norm(t)

        summary = run_pose_benchmark(model, poses, estimator=estimator, repeats=2, sample_n=64, seed=3,
                                     progress=False, **kw)
        return summary, seen

    (got, got_k), (want, want_k) = run(batch_size=2, devices=["cpu", "cpu"]), run(batch_size=1)
    assert got == want
    assert len(got_k) == len(want_k) == 6
    for (a1, a2), (b1, b2) in zip(got_k, want_k):
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
