"""The training recipe of the port end to end on the CPU, at
RoMaConfig.tiny(): resume (3 steps straight against 2, a save, a restore
into a fresh net and optimizer, 1 step: parameters, statistics, moments,
step, learning rates and EMA bit for bit, tolerance 0); the dense benchmark
(``_geometric_dist`` against JAX's on seeded inputs, rtol 1e-5; the whole
benchmark on the MegaDepth fixture with a ground-truth oracle returning
JAX's dict, rtol 1e-5); the profiling utilities; and build() plus CPU steps
of each entry module on the fixture trees (tests/fixtures_realformat.py)."""
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures_realformat import make_megadepth_fixture, make_scannet_fixture

from roma_tpu.benchmarks import mega_dense as jax_dense
from roma_tpu.datasets.megadepth import MegadepthBuilder as JaxMegaBuilder
from roma_tpu_torch.benchmarks import MegadepthDenseBenchmark, mega_dense
from roma_tpu_torch.datasets.megadepth import MegadepthBuilder
from roma_tpu_torch.experiments import common, train_roma_indoor, train_roma_outdoor, train_tiny_roma_v1_outdoor
from roma_tpu_torch.models.config import RoMaConfig
from roma_tpu_torch.models.tiny import TinyRoMaNet
from roma_tpu_torch.models.zoo import init_random, train_net
from roma_tpu_torch.models.zoo.convert import XFEAT_PREFIX, to_reference
from roma_tpu_torch.parallel import dist
from roma_tpu_torch.train import (
    CheckPoint,
    RobustLosses,
    get_gt_warp,
    init_train_state,
    make_optimizer,
    make_train_step,
    train_k_steps,
)
from roma_tpu_torch.utils import profiling
from torch_dist_worker import seeded_batch
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

TINY = RoMaConfig.tiny()


# --- resume ------------------------------------------------------------------

def _recipe_state(seed: int):
    net = train_net(TINY, "cpu", seed=seed, remat=True)
    # a warmup and a milestone inside the 3 steps, so the schedule must resume
    opt = make_optimizer(net, encoder_lr=3e-5, decoder_lr=4e-4, milestones=(2,), warmup_steps=2)
    return init_train_state(net, opt), make_train_step(net, RobustLosses(), opt)


def _snapshot(state) -> dict:
    return {"sd": {k: v.clone() for k, v in state.net.state_dict().items()},
            "adam": {i: {k: v.clone() for k, v in s.items()}
                     for i, s in enumerate(state.optimizer.adamw.state.values())},
            "lr": [g["lr"] for g in state.optimizer.param_groups], "count": state.optimizer.count,
            "step": state.step, "ema": {k: v.clone() for k, v in state.ema_params.items()}}


def test_resume_is_bitwise(tmp_path):
    """On one CPU thread (the module's fixture): on several, the
    accumulating scatter of the plain local correlation's backward sums in
    a varying order, which moves the float-noise gradients of the conv
    biases in front of a BatchNorm, and AdamW's first steps magnify those."""
    batches = [{k: torch.from_numpy(v) for k, v in seeded_batch(2, 56, 20 + i).items()} for i in range(3)]
    straight, step = _recipe_state(0)
    straight, _ = train_k_steps(straight, batches, step, ema_decay=0.9)

    first, step = _recipe_state(0)
    first, _ = train_k_steps(first, batches[:2], step, ema_decay=0.9)
    CheckPoint(str(tmp_path), "resume").save(first)
    resumed, step = _recipe_state(seed=5)  # other weights, a fresh optimizer
    resumed = CheckPoint(str(tmp_path), "resume").load(resumed)
    assert resumed.step == 2 and resumed.optimizer.count == 2
    resumed, _ = train_k_steps(resumed, batches[2:], step, ema_decay=0.9)

    a, b = _snapshot(straight), _snapshot(resumed)
    assert a["step"] == b["step"] == 3 and a["count"] == b["count"] == 3
    assert a["lr"] == b["lr"] == [3e-5 * 0.2, 4e-4 * 0.2]
    for k in a["sd"]:
        assert torch.equal(a["sd"][k], b["sd"][k]), k
    for i in a["adam"]:
        assert all(torch.equal(v, b["adam"][i][k]) for k, v in a["adam"][i].items()), i
    for k in a["ema"]:
        assert torch.equal(a["ema"][k], b["ema"][k]), k


# --- the dense benchmark -------------------------------------------------------

def test_geometric_dist_matches_jax():
    rs = np.random.RandomState(0)
    b, h = 2, 12
    batch = seeded_batch(b, h, 3)
    batch["T_1to2"][:, 0, 3] = 0.05
    batch["im_B_depth"] *= 1 + 0.02 * rs.randn(b, h, h).astype(np.float32)
    grid = np.stack(np.meshgrid(np.linspace(-1 + 1 / h, 1 - 1 / h, h), np.linspace(-1 + 1 / h, 1 - 1 / h, h),
                                indexing="xy"), -1)
    matches = np.concatenate([np.repeat(grid[None], b, 0), grid[None] + 0.3 * rs.randn(b, h, h, 2)], -1)
    matches = matches.astype(np.float32)
    args = [batch[k] for k in ("im_A_depth", "im_B_depth", "T_1to2", "K1", "K2")] + [matches]
    want = jax_dense._geometric_dist(*map(jnp.asarray, args), h1=h, w1=h)
    got = mega_dense._geometric_dist(*map(torch.from_numpy, args), h1=h, w1=h)
    assert 0 < float(want[1]) < float(want[3]) < 1
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.item(), float(j), rtol=1e-5)


@pytest.fixture(scope="module")
def mega_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mega")
    for s in ("0015", "0022"):  # test_loftr's scenes, the benchmark's default split
        make_megadepth_fixture(root, scene=s)
    for s in ("0001", "0002"):
        make_megadepth_fixture(root, scene=s)
    return str(root)


class Oracle:
    """A matcher returning the ground-truth warp of each pair, looked up by
    its image A's bytes; the GT warp is computed once with the port's
    get_gt_warp, so both benchmarks see the same predictions."""

    symmetric = False
    device = torch.device("cpu")

    def __init__(self, dataset, to_array):
        self.table, self.to_array = {}, to_array
        for i in range(len(dataset)):
            it = dataset[i]
            d = {k: torch.from_numpy(it[k])[None] for k in ("im_A_depth", "im_B_depth", "T_1to2", "K1", "K2")}
            h, w = it["im_A"].shape[:2]
            x2, prob = get_gt_warp(d["im_A_depth"], d["im_B_depth"], d["T_1to2"], d["K1"], d["K2"], H=h, W=w)
            ys, xs = torch.meshgrid(torch.linspace(-1 + 1 / h, 1 - 1 / h, h),
                                    torch.linspace(-1 + 1 / w, 1 - 1 / w, w), indexing="ij")
            warp = torch.cat((torch.stack((xs, ys), -1)[None], x2), -1)[0]
            self.table[it["im_A"].tobytes()] = (warp.numpy(), prob[0].numpy())

    def match(self, im_A, im_B, batched=True):
        rows = [self.table[np.asarray(im).astype(np.float32).tobytes()] for im in im_A]
        return self.to_array(np.stack([r[0] for r in rows])), self.to_array(np.stack([r[1] for r in rows]))


def test_dense_benchmark_matches_jax_on_the_fixture(mega_root, tmp_path):
    kw = dict(h=42, w=56, num_samples=5, seed=3)
    port = MegadepthDenseBenchmark(mega_root, **kw)
    ref = jax_dense.MegadepthDenseBenchmark(mega_root, **kw)
    assert len(port.dataset) == len(ref.dataset) == 6
    got = port.benchmark(Oracle(port.dataset, torch.from_numpy), batch_size=2, debug_dir=str(tmp_path))
    want = ref.benchmark(Oracle(port.dataset, jnp.asarray), batch_size=2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["epe"] < 0.05 and got["mega_pck_1"] > 0.99  # the oracle is right wherever the GT is valid
    # 5 samples at batch 2: the ragged fifth is dropped, two batches of two dumped
    assert len(list(tmp_path.iterdir())) == 4
    assert {p.name for p in next(tmp_path.iterdir()).iterdir()} == {"warp.jpg", "im_A.jpg", "im_B.jpg"}


def test_dense_benchmark_takes_a_dataset(mega_root):
    ds = MegadepthBuilder(mega_root).build_concat(split="train", ht=28, wt=42)
    bench = MegadepthDenseBenchmark(dataset=ds, num_samples=100)
    ref = jax_dense.MegadepthDenseBenchmark(dataset=JaxMegaBuilder(mega_root).build_concat(
        split="train", ht=28, wt=42), num_samples=100)
    got = bench.benchmark(Oracle(ds, torch.from_numpy), batch_size=4)
    want = ref.benchmark(Oracle(ds, jnp.asarray), batch_size=4)
    assert bench.dataset is ds and len(ds) == 12
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


# --- profiling -----------------------------------------------------------------

def test_step_timer_skips_its_warmup(monkeypatch):
    clock = iter([0.0, 5.0, 10.0, 11.0, 20.0, 23.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(items_per_step=8, warmup=1)
    for _ in range(3):
        with timer:
            pass
    assert timer.times == [1.0, 3.0] and timer.mean_step_time == 2.0 and timer.items_per_sec == 4.0
    assert profiling.StepTimer().items_per_sec == 0.0


def test_metric_logger_writes_on_rank_0_only(tmp_path, monkeypatch, capsys):
    log = profiling.MetricLogger(file=str(tmp_path / "m.jsonl"))
    log.log({"loss": torch.tensor(1.5), "lr": 0.1}, step=3)
    log.close()
    assert json.loads((tmp_path / "m.jsonl").read_text()) == {"step": 3, "loss": 1.5, "lr": 0.1}
    profiling.MetricLogger().log({"loss": 2.0}, step=4)
    assert json.loads(capsys.readouterr().out) == {"step": 4, "loss": 2.0}
    monkeypatch.setattr(dist, "rank", lambda: 1)
    other = profiling.MetricLogger(use_wandb=True, file=str(tmp_path / "r1.jsonl"))
    other.log({"loss": 1.0}, step=1)
    assert not other.enabled and not (tmp_path / "r1.jsonl").exists() and capsys.readouterr().out == ""


def test_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("step"):
            torch.ones(4).sum()
    assert any(tmp_path.rglob("*.json"))


# --- the entry points ----------------------------------------------------------

@pytest.fixture
def low_56(monkeypatch):
    """The recipe's "low" resolution cut to 56^2 for the CPU."""
    monkeypatch.setitem(common.RESOLUTIONS, "low", (56, 56))


def _args(module, *extra):
    return module.parser().parse_args([
        "--device", "cpu", "--gpu_batch_size", "2", "--num_workers", "2", "--log_every", "1",
        *extra])


def test_train_roma_outdoor_on_the_fixture(mega_root, tmp_path, low_56, capsys, monkeypatch):
    """build() at the tiny config, its flags' defaults as JAX's, one epoch of
    the recipe cut to 4 samples (loader, 2 steps, checkpoint, dense
    benchmark), then a second build that resumes from the checkpoint."""
    monkeypatch.setattr(common, "K_SAMPLES", 4)
    defaults = train_roma_outdoor.parser().parse_args([])
    assert (defaults.gpu_batch_size, defaults.train_resolution, defaults.remat, defaults.bf16,
            defaults.pretrained_backbone, defaults.ema_decay, defaults.warmup_steps, defaults.device) == \
        (8, "medium", True, True, True, 0.0, 0, "cuda")
    args = _args(train_roma_outdoor, "--data_root", mega_root, "--ckpt_dir", str(tmp_path), "--train_resolution",
                 "low", "--no-pretrained_backbone", "--ema_decay", "0.9")
    r = train_roma_outdoor.build(args, config=TINY)
    # two overlap bands of the two train_loftr scenes: 3 + 3 pairs each
    assert len(r.dataset) == 12 and np.allclose(r.weights, 1 / 3 ** 0.75)
    assert r.hw == (56, 56) and r.batch_size == 2 and r.n_steps == 4_000_000
    assert r.state.net.encoder.remat and r.state.net.decoder.remat
    metrics = train_roma_outdoor.train_epoch(
        r, args, np.random.RandomState(0), MegadepthDenseBenchmark(dataset=r.dataset, num_samples=4))
    out = capsys.readouterr().out
    assert r.state.step == 2 and np.isfinite(float(metrics["loss"])) and "step 2: loss=" in out
    assert json.loads(out.strip().splitlines()[-1])["step"] == 2
    again = train_roma_outdoor.build(args, config=TINY)
    assert again.state.step == 2 and again.state.optimizer.count == 2 and again.state.ema_params is not None


def test_train_roma_indoor_on_the_fixtures(mega_root, tmp_path_factory, tmp_path, low_56):
    scan_root = tmp_path_factory.mktemp("scannet")
    make_scannet_fixture(scan_root)
    args = _args(train_roma_indoor, "--mega_root", mega_root, "--scannet_root", str(scan_root), "--ckpt_dir",
                 str(tmp_path), "--train_resolution", "low", "--no-pretrained_backbone")
    r = train_roma_indoor.build(args, config=TINY)
    assert sorted(r.step) == sorted(r.dataset) == ["mega", "scannet"]
    assert len(r.dataset["mega"]) == 6 and len(r.dataset["scannet"]) == 2
    seen = []
    for name in ("mega", "scannet"):
        step = r.step[name]
        r.step[name] = lambda b, name=name, step=step: seen.append(name) or step(b)
    metrics = train_roma_indoor.train_epoch(r, args, np.random.RandomState(0))
    # in turn until the ScanNet stream (one batch of 2) runs out
    assert seen == ["mega", "scannet", "mega"] and r.state.step == 3 and np.isfinite(float(metrics["loss"]))
    assert CheckPoint(str(tmp_path), "train_roma_indoor")._files()[-1].name == "step_3.pt"


@pytest.mark.parametrize("module", [train_roma_outdoor, train_roma_indoor, train_tiny_roma_v1_outdoor])
def test_distributed_without_a_card_raises(module, monkeypatch):
    """--distributed on the default device asks for the card (nccl): with
    none, build() raises rather than train on the CPU under gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        module.build(module.parser().parse_args(["--distributed"]))
    assert not dist.active()


def test_train_tiny_roma_on_the_fixture(mega_root, tmp_path, capsys, monkeypatch):
    """XFeat comes from --xfeat_weights (a hub-layout file of seeded weights,
    heads included), tensor for tensor, and stays frozen over 2 steps;
    without the flag and offline it stays random and says so."""
    monkeypatch.setenv("ROMA_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")
    train_tiny_roma_v1_outdoor.tiny_train_net("cpu")
    assert "XFeat weights unavailable" in capsys.readouterr().out
    donor = init_random(TinyRoMaNet(train_mode=True, freeze_xfeat=True), seed=3)
    with torch.no_grad():
        for m in donor.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.8, 1.2)
    xfeat_sd = to_reference(donor, XFEAT_PREFIX)[1]
    torch.save({**xfeat_sd, "keypoint_head.0.layer.0.weight": torch.randn(64, 64, 1, 1)}, tmp_path / "xfeat.pt")
    args = _args(train_tiny_roma_v1_outdoor, "--data_root", mega_root, "--ckpt_dir", str(tmp_path),
                 "--h", "64", "--w", "96", "--xfeat_weights", str(tmp_path / "xfeat.pt"))
    r = train_tiny_roma_v1_outdoor.build(args)
    assert "unavailable" not in capsys.readouterr().out
    assert r.dataset[0]["im_A"].min() >= 0  # images in [0, 1], not normalized
    xfeat = {k: v.clone() for k, v in r.state.net.state_dict().items() if k.startswith("xfeat.")}
    assert sorted(k[len(XFEAT_PREFIX):] for k in xfeat if not k.endswith("num_batches_tracked")) == sorted(xfeat_sd)
    assert all(torch.equal(xfeat[XFEAT_PREFIX + k], v) for k, v in xfeat_sd.items())
    loader = common.epoch_loader(r.dataset, r.weights, r.batch_size, np.random.RandomState(0), 2)
    r.state, metrics = train_k_steps(r.state, itertools.islice(common.DeviceBatches(loader, r.device), 2), r.step)
    assert r.state.step == 2 and np.isfinite(float(metrics["loss"]))
    assert all(torch.equal(v, r.state.net.state_dict()[k]) for k, v in xfeat.items())
    with pytest.raises(ValueError):
        train_tiny_roma_v1_outdoor.build(args, config=TINY)
