"""The port's evaluation, release-gate and demo entry points
(roma_tpu_torch/experiments/eval_*.py, validate_release.py,
roma_tpu_torch/demo/) on the CPU: each eval on a fixture tree in its
benchmark's real layout (tests/fixtures_realformat.py, and a Mega-1500
scene written under the benchmark's scene names) with RoMaConfig.tiny()
injected through ``build(args, config)``, writing its JSON; the release
gate's smoke run at the tiny widths, and its strict load refusing a planted
and a dropped key; each demo on two synthetic PNGs."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from fixtures_realformat import make_hpatches_fixture, make_scannet1500_fixture
from PIL import Image

from roma_tpu_torch.benchmarks import MEGA_8_SCENES, MEGA_1500_SCENES
from roma_tpu_torch.demo import demo_3D_effect, demo_fundamental, demo_match, demo_match_tiny
from roma_tpu_torch.experiments import (
    eval_hpatches,
    eval_roma_indoor,
    eval_roma_outdoor,
    eval_tiny_roma_v1_outdoor,
    validate_release,
)
from roma_tpu_torch.models import RoMaConfig
from roma_tpu_torch.models.blocks import QConv1x1
from roma_tpu_torch.models.vit import QLinear
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

TINY = RoMaConfig.tiny()
SMALL = ["--device", "cpu", "--coarse_res", "56", "--upsample_res", "64"]
AUC_KEYS = {"auc_5", "auc_10", "auc_20"}


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")


@pytest.fixture(scope="module")
def mega_root(tmp_path_factory):
    """A Mega-1500 tree: a scene .npz under every Mega-1500 and
    Mega-8-scenes name, the first of each list with one pair (two cameras 1
    m apart before seeded images), the others with none (RANSAC on a
    random-weight match runs all its iterations: ~1 s a repeat)."""
    root = tmp_path_factory.mktemp("mega")
    rs = np.random.RandomState(0)
    os.makedirs(root / "imgs")
    paths = []
    for i, (w, h) in enumerate([(160, 120), (200, 96)]):
        p = f"imgs/{i}.jpg"
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(root / p)
        paths.append(p)
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]])
    T = [np.eye(4), np.eye(4)]
    T[1][:3, 3] = [1, 0, 0]
    for names in (MEGA_1500_SCENES, MEGA_8_SCENES):
        for i, name in enumerate(names):
            pairs = np.array([((0, 1), 0.5, None)] if i == 0 else [], dtype=object)
            np.savez(root / name, pair_infos=pairs, intrinsics=np.stack([K, 1.1 * K]), poses=np.stack(T),
                     image_paths=np.array(paths))
    return str(root)


def _results(path) -> dict:
    with open(path) as f:
        return json.load(f)


def test_eval_roma_outdoor_int8_writes_its_json(mega_root, tmp_path):
    out = tmp_path / "outdoor.json"
    args = eval_roma_outdoor.parser().parse_args(
        ["--data_root", mega_root, "--mega_8_scenes", "--vit_int8", "--refiner_int8", "--out", str(out), *SMALL])
    model = eval_roma_outdoor.build(args, config=TINY)
    assert model.net.config.vit_int8 and model.net.config.refiner_int8
    assert any(isinstance(m, QConv1x1) for m in model.net.modules())
    assert any(isinstance(m, QLinear) and m.int8 for m in model.net.modules())
    got = eval_roma_outdoor.run(args, model)
    assert _results(out) == json.loads(json.dumps(got, default=float))
    assert set(got) == {"mega1500", "mega_8_scenes"}
    assert all(AUC_KEYS <= set(r) and all(0 <= r[k] <= 1 for k in AUC_KEYS) for r in got.values())


def test_eval_roma_indoor_writes_its_json(tmp_path):
    root, _ = make_scannet1500_fixture(tmp_path / "scannet")
    out = tmp_path / "indoor.json"
    args = eval_roma_indoor.parser().parse_args(["--data_root", root, "--out", str(out), *SMALL])
    got = eval_roma_indoor.run(args, eval_roma_indoor.build(args, config=TINY))
    assert set(_results(out)) == {"scannet"} and AUC_KEYS <= set(got["scannet"])


def test_eval_hpatches_writes_its_json(tmp_path):
    root, _ = make_hpatches_fixture(tmp_path / "hpatches")
    out = tmp_path / "hp.json"
    args = eval_hpatches.parser().parse_args(["--data_root", root, "--out", str(out), *SMALL])
    got = eval_hpatches.run(args, eval_hpatches.build(args, config=TINY))
    assert _results(out) == got and set(got["hpatches"]) == {f"hpatches_homog_auc_{t}" for t in (3, 5, 10)}


def test_eval_tiny_roma_writes_its_json(mega_root, tmp_path):
    out = tmp_path / "tiny.json"
    args = eval_tiny_roma_v1_outdoor.parser().parse_args(["--data_root", mega_root, "--device", "cpu",
                                                          "--out", str(out)])
    got = eval_tiny_roma_v1_outdoor.run(args)  # seeded weights: offline, no file given
    assert set(_results(out)) == {"mega1500"} and AUC_KEYS <= set(got["mega1500"])
    with pytest.raises(ValueError, match="one architecture"):
        eval_tiny_roma_v1_outdoor.build(args, config=TINY)


def test_release_gate_smoke_passes_stages_1_to_4(tmp_path):
    out = tmp_path / "gate.json"
    assert validate_release.main(["--smoke", "--config", "tiny", "--device", "cpu", "--out", str(out)]) == 0
    report = _results(out)
    assert report["mode"] == "smoke" and report["res"] == [56, 64] and report["gm_bias"] == "peaked"
    for stage in ("convert", "strict_load", "f32_parity", "bf16_drift"):
        assert report[stage]["ok"] is True, stage
    assert report["convert"]["fp16_tensors"] > 0
    assert report["f32_parity"]["worst_p99_px"] < validate_release.P99_PX
    assert report["golden_metrics"] == {"ok": None, "skipped": "smoke mode"}


@pytest.mark.parametrize("tamper", ["planted", "dropped"])
def test_release_gate_strict_load_refuses_key_drift(tamper, tmp_path):
    """A key the port has no place for, or a port tensor the file lacks,
    fails stage 2 and exits 1; the report names the key."""
    roma_path, dino_path = validate_release.fabricate_pair(TINY, str(tmp_path))
    sd = torch.load(roma_path, weights_only=True)
    if tamper == "planted":
        key = "decoder.conv_refiner.16.extra.weight"
        sd[key] = torch.zeros(3)
    else:
        key = "decoder.conv_refiner.8.block1.3.bias"
        del sd[key]
    torch.save(sd, roma_path)
    out = tmp_path / "gate.json"
    assert validate_release.main(["--weights", roma_path, "--dinov2_weights", dino_path, "--config", "tiny",
                                  "--device", "cpu", "--res", "56", "--up", "64", "--out", str(out)]) == 1
    report = _results(out)
    assert report["convert"]["ok"] is True and report["strict_load"]["ok"] is False
    assert report["strict_load"]["unexpected" if tamper == "planted" else "missing"] == [key]
    assert "f32_parity" not in report


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    base = (np.random.RandomState(0).rand(90, 120, 3) * 255).astype(np.uint8)
    Image.fromarray(base).save(d / "a.png")
    Image.fromarray(np.roll(base, 3, axis=1)).save(d / "b.png")
    return d, ["--im_A_path", str(d / "a.png"), "--im_B_path", str(d / "b.png"), "--device", "cpu"]


def test_demo_match(pngs):
    d, pair = pngs
    args = demo_match.parser().parse_args([*pair, "--coarse_res", "56", "--upsample_res", "64",
                                           "--save_path", str(d / "warp.png")])
    warp, cert = demo_match.run(args, demo_match.build(args, config=TINY))
    assert tuple(warp.shape) == (64, 128, 4) and Image.open(d / "warp.png").size == (128, 64)


def test_demo_match_tiny(pngs):
    d, pair = pngs
    args = demo_match_tiny.parser().parse_args([*pair, "--save_A_path", str(d / "ab.png"),
                                                "--save_B_path", str(d / "ba.png")])
    (w_ab, _), (w_ba, _) = demo_match_tiny.run(args)
    assert tuple(w_ab.shape) == tuple(w_ba.shape) == (90, 120, 4)
    assert Image.open(d / "ab.png").size == Image.open(d / "ba.png").size == (120, 90)


def test_demo_fundamental(pngs, capsys):
    d, pair = pngs
    args = demo_fundamental.parser().parse_args([*pair, "--coarse_res", "56", "--upsample_res", "64"])
    F, mask = demo_fundamental.run(args, demo_fundamental.build(args, config=TINY))
    assert F is not None and F.shape[1] == 3 and np.isfinite(F).all() and "inliers:" in capsys.readouterr().out


def test_demo_3d_effect(pngs):
    d, pair = pngs
    args = demo_3D_effect.parser().parse_args([*pair, "--coarse_res", "56", "--upsample_res", "64",
                                               "--save_path", str(d / "parallax.gif")])
    frames = demo_3D_effect.run(args, demo_3D_effect.build(args, config=TINY))
    gif = Image.open(d / "parallax.gif")
    # the GIF writer merges the two equal frames at the turn
    assert len(frames) == 2 * demo_3D_effect.FRAMES and gif.n_frames >= len(frames) - 1 and gif.size == (64, 64)


@pytest.mark.parametrize("module", [demo_match, demo_match_tiny, demo_fundamental, demo_3D_effect])
def test_demos_require_the_image_paths(module):
    """No demo falls back to an image path of its own."""
    with pytest.raises(SystemExit):
        module.parser().parse_args([])


@pytest.mark.parametrize("module", [eval_roma_outdoor, eval_roma_indoor, eval_hpatches, demo_match, demo_3D_effect],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_points_build_on_the_card_unless_asked(module, tmp_path):
    """The default device is the card; without one, build raises instead of
    running on the CPU."""
    argv = ["--im_A_path", "a", "--im_B_path", "b"] if "demo" in module.__name__ else []
    args = module.parser().parse_args(argv)
    assert args.device == "cuda" and validate_release.parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        assert next(module.build(args, config=TINY).net.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            module.build(args, config=TINY)
