"""The one staging helper (roma_tpu_torch/utils/staging.py) that takes host
arrays to a device for the matcher's prep, MatchEngine and the loader.

Arrays of mixed dtypes and shapes come back equal, in their dtypes and
shapes, one by one or stacked; a larger second call grows the pinned buffer
and leaves the first call's tensors as they were; a non-CUDA device pins
nothing. The tests marked ``card`` also hold engine batches and loader
batches issued back to back behind a busy card, with no synchronization, to
the same calls each synchronized, and threads sharing the loader's helper to
their own arrays; they skip without a CUDA device and run on the card with

    python3 -m pytest tests/test_torch_staging.py -m card
"""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

from roma_tpu_torch.datasets import loader
from roma_tpu_torch.utils.staging import PinnedStaging
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)


def _arrays(seed: int, scale: int = 1) -> list:
    """One call's arrays: dtypes of one to eight bytes in an order that
    needs alignment (a float64 after an odd number of bytes), a read-only
    array, a 0-d one and an empty one."""
    rs = np.random.RandomState(seed)
    ro = rs.rand(3, 4).astype(np.float32)
    ro.setflags(write=False)
    return [rs.randint(0, 256, (5 * scale, 7, 3)).astype(np.uint8), rs.rand(2 * scale, 3),
            ro, rs.randint(-9, 9, (scale, 3)).astype(np.int64), rs.rand(4) > 0.5,
            np.float32(rs.rand()).reshape(()), np.zeros((0, 2), np.float32),
            rs.randint(0, 256, (1,)).astype(np.uint8), rs.rand(scale, 2).astype(np.float64)]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.card)]


def _equal(got: torch.Tensor, want: np.ndarray, device: torch.device) -> bool:
    return (got.device.type == device.type and got.dtype == torch.from_numpy(np.empty(0, want.dtype)).dtype
            and tuple(got.shape) == want.shape and np.array_equal(got.cpu().numpy(), want))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("calls", [[(0, 1)], [(1, 1), (2, 40)]], ids=["mixed dtypes and shapes", "a larger second"])
def test_staged_arrays_equal_their_sources(calls, device):
    """Each call's tensors equal its arrays, after every later call too; on
    a card the pinned buffer grows to the largest call, on the CPU nothing
    is pinned."""
    dev = _device(device)
    staging = PinnedStaging()
    done, sizes = [], []
    for seed, scale in calls:
        arrays = _arrays(seed, scale)
        done.append((staging.to_device(arrays, dev), arrays))
        sizes.append(None if staging._buf is None else staging._buf.numel())
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert staging._buf.is_pinned() and sizes == sorted(set(sizes))
        assert sizes[-1] >= sum(a.nbytes for a in done[-1][1])
    else:
        assert sizes == [None] * len(calls)
    for got, arrays in done:
        assert len(got) == len(arrays)
        assert all(_equal(g, a, dev) for g, a in zip(got, arrays))
        assert dev.type == "cuda" or not any(g.is_pinned() for g in got)


@pytest.mark.parametrize("device", DEVICES)
def test_stacked_arrays_are_one_tensor(device):
    dev = _device(device)
    rs = np.random.RandomState(3)
    arrays = [rs.randint(0, 256, (9, 11, 3)).astype(np.uint8) for _ in range(3)]
    staging = PinnedStaging()
    got = staging.to_device(arrays, dev, stack=True)
    assert got.is_contiguous() and _equal(got, np.stack(arrays), dev)
    with pytest.raises(ValueError, match="one shape and dtype"):
        staging.to_device([arrays[0], arrays[1][:5]], dev, stack=True)
    with pytest.raises(ValueError, match="one shape and dtype"):
        staging.to_device([arrays[0], arrays[1].astype(np.float32)], dev, stack=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _batches(n: int, seed: int = 0) -> list:
    """Loader batches: float32 images and depths, float64 poses, uint8."""
    rs = np.random.RandomState(seed)
    return [{"im_A": rs.rand(2, 64, 64, 3).astype(np.float32), "u8": rs.randint(0, 256, (2, 33)).astype(np.uint8),
             "im_A_depth": rs.rand(2, 64, 64).astype(np.float32), "T_1to2": rs.rand(2, 4, 4)} for _ in range(n)]


@pytest.mark.card
def test_unsynchronized_loader_batches_equal_synchronized_ones():
    """Batches staged back to back behind a busy card, each read on the
    current stream and dropped: the reads equal the same calls each
    synchronized. A copy that overwrote a batch the current stream has yet
    to read (its memory handed on too early) would show here."""
    dev = _device("cuda")

    def staged(b):
        return {k: v.clone() for k, v in loader.to_device(b, dev).items()}

    batches = _batches(6)
    synced = []
    for b in batches:
        synced.append(staged(b))
        torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # the card busy: each clone below waits behind it, its copy does not
    loose = [staged(b) for b in batches]
    torch.cuda.synchronize()
    for k, (want, got) in enumerate(zip(synced, loose)):
        assert all(torch.equal(want[n], got[n]) for n in want), k
        assert all(np.array_equal(got[n].cpu().numpy(), batches[k][n]) for n in want), k


@pytest.mark.card
def test_unsynchronized_engine_batches_equal_synchronized_ones():
    """MatchEngine batches dispatched back to back behind a busy card, with
    no synchronization, give the results of the same batches each
    synchronized."""
    from roma_tpu_torch.models.config import RoMaConfig
    from roma_tpu_torch.models.zoo import roma_outdoor
    from roma_tpu_torch.serving import MatchEngine

    _device("cuda")
    model = roma_outdoor(config=RoMaConfig.tiny(), amp=True, device="cuda")
    engine = MatchEngine(model, batch_size=2)
    rs = np.random.RandomState(5)
    canvas = {"im_A": (560, 560), "im_B": (560, 560), "im_A_high_res": (864, 864), "im_B_high_res": (864, 864)}
    batches = [{k: rs.randint(0, 256, (2, *hw, 3)).astype(np.uint8) for k, hw in canvas.items()} for _ in range(3)]
    synced = []
    for b in batches:
        synced.append([(w.clone(), c.clone()) for w, c, _ in engine._dispatch(b)])
        torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    loose = [engine._dispatch(b) for b in batches]
    torch.cuda.synchronize()
    for k, (want, got) in enumerate(zip(synced, loose)):
        assert all(torch.equal(w0, w1) and torch.equal(c0, c1) for (w0, c0), (w1, c1, _) in zip(want, got)), k


@pytest.mark.card
def test_threads_sharing_the_loader_staging_get_their_own_arrays():
    """16 threads (more than the host's cores) stage their own batches
    through the loader's one helper at once, with a short switch interval:
    every thread reads back its own arrays."""
    dev = _device("cuda")
    per_thread = [_batches(4, seed=t) for t in range(16)]
    got: dict[int, list] = {}

    def work(t):
        got[t] = [{k: v.cpu() for k, v in loader.to_device(b, dev).items()} for b in per_thread[t]]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    for t, batches in enumerate(per_thread):
        for want, out in zip(batches, got[t]):
            assert all(np.array_equal(out[k].numpy(), v) for k, v in want.items()), t


@pytest.mark.card
def test_two_replicas_on_the_card_equal_one_replica_bit_for_bit():
    """Two replicas on the one card, each shard staged through the engine's
    helper, give one replica's results bit for bit."""
    from roma_tpu_torch.models.config import RoMaConfig
    from roma_tpu_torch.models.zoo import roma_outdoor
    from roma_tpu_torch.serving import MatchEngine

    _device("cuda")
    model = roma_outdoor(config=RoMaConfig.tiny(), amp=True, device="cuda")
    rs = np.random.RandomState(7)
    pairs = [tuple(rs.randint(0, 256, (720, 960, 3)).astype(np.uint8) for _ in range(2)) for _ in range(6)]
    two = list(MatchEngine(model, batch_size=4, devices=["cuda:0", "cuda:0"]).match_paths(pairs, on_host=True))
    one = list(MatchEngine(model, batch_size=2).match_paths(pairs, on_host=True))
    assert [r.index for r in two] == [r.index for r in one] == list(range(len(pairs)))
    for g, w in zip(two, one):
        assert np.array_equal(g.warp, w.warp) and np.array_equal(g.certainty, w.certainty)
