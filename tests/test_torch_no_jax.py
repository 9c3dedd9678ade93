"""The port stands alone: it imports no JAX, Flax, Optax, Orbax, roma_tpu,
graveyard or tools (the training package, the port's graveyard and tools,
its model zoo's loader and download modules, Tiny RoMa's modules, the int8
path, the eval, release-gate and demo entry points included) and reads no
file of the reference checkout, its entry points build on the card unless
asked for the CPU, and
on CPU tensors every kernel wrapper runs its plain version without
launching."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import roma_tpu_torch
from roma_tpu_torch.models import RoMaConfig, roma_indoor, roma_outdoor, tiny_roma_v1_outdoor, train_net
from roma_tpu_torch.models.zoo import build_net
from roma_tpu_torch.ops import (
    KERNEL_WRAPPERS,
    attention_backward_reference,
    attention_packed_reference,
    compact_miss,
    compact_miss_reference,
    fold_block,
    fused_attention,
    fused_attention_backward,
    fused_attention_packed,
    fused_refiner_stack,
    fused_refiner_stack_packed,
    hcw_refiner_block,
    lane_refiner_block,
    local_correlation,
    local_correlation_reference,
    onehot_dot,
    onehot_dot_reference,
    refiner_stack_reference,
    resize_normalize,
    resize_normalize_reference,
    sdpa_reference,
    warp_sample,
    warp_sample_reference,
    warp_tiles,
    warp_tiles_reference,
    warp_tiles_v1,
    wide_refiner_stack_reference,
    window_sum,
    window_sum_reference,
)

PKG = Path(roma_tpu_torch.__file__).parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "roma_tpu", "graveyard", "tools")


def test_imports_and_matches_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "import numpy as np\n"
        "from roma_tpu_torch import roma_indoor, roma_outdoor, RoMaConfig\n"
        "from roma_tpu_torch.models import pretrained_backbone\n"
        "import roma_tpu_torch.models.zoo.convert, roma_tpu_torch.models.zoo.download\n"
        "import roma_tpu_torch.train\n"
        "import roma_tpu_torch.datasets, roma_tpu_torch.parallel, roma_tpu_torch.utils.profiling\n"
        "import roma_tpu_torch.benchmarks.mega_dense\n"
        "import roma_tpu_torch.experiments.train_roma_outdoor, roma_tpu_torch.experiments.train_roma_indoor\n"
        "import roma_tpu_torch.experiments.train_tiny_roma_v1_outdoor\n"
        "import roma_tpu_torch.graveyard.pallas_hcw_refiner, roma_tpu_torch.graveyard.pallas_refiner_lanemajor\n"
        "import roma_tpu_torch.tools.bench_onehot_dots, roma_tpu_torch.tools.bench_hcw_refiner\n"
        "m = roma_outdoor(device=\"cpu\", amp=False, coarse_res=56, upsample_res=64, config=RoMaConfig.tiny())\n"
        "rs = np.random.RandomState(0)\n"
        "w, c = m.match(rs.randn(56, 56, 3).astype('float32'), rs.randn(56, 56, 3).astype('float32'))\n"
        "assert tuple(w.shape) == (64, 128, 4) and tuple(c.shape) == (64, 128)\n"
        "from roma_tpu_torch import tiny_roma_v1_outdoor, TinyRoMa, TinyRoMaNet, XFeatBackbone\n"
        "import roma_tpu_torch.models.xfeat, roma_tpu_torch.models.tiny, roma_tpu_torch.train.losses_tiny\n"
        "from roma_tpu_torch.train import TinyRobustLosses\n"
        "t = tiny_roma_v1_outdoor(device=\"cpu\")\n"
        "w, c = t.match(rs.rand(70, 90, 3).astype('float32'), rs.rand(70, 90, 3).astype('float32'))\n"
        "assert tuple(w.shape) == (70, 90, 4) and tuple(c.shape) == (70, 90)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert not any(k == b or k.startswith(b + '.') for k in loaded\n"
        "               for b in ('roma_tpu', 'flax', 'optax', 'orbax', 'graveyard', 'tools'))\n"
        "print('ok')\n"
    )
    # offline: the released Tiny RoMa's weights are never fetched, seeded random ones are drawn
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=300, env={**os.environ, "ROMA_TPU_OFFLINE": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_evaluation_modules_load_no_jax_cv2_or_tqdm():
    """serving (and the package's MatchEngine, get_devices and utils),
    benchmarks, native and tools.crossimpl import with JAX, the JAX package,
    OpenCV and tqdm all unimportable (OpenCV and tqdm are imported inside
    the functions that use them)."""
    code = (
        "import sys\n"
        f"for m in {BANNED + ('cv2', 'tqdm')!r}: sys.modules[m] = None\n"
        "import roma_tpu_torch.serving, roma_tpu_torch.benchmarks, roma_tpu_torch.native\n"
        "from roma_tpu_torch import MatchEngine\n"
        "from roma_tpu_torch.parallel import get_devices\n"
        "from roma_tpu_torch.utils import check_not_i16, check_rgb, prepare\n"
        "from roma_tpu_torch.ops import attention_packed, corr_volume, to_pixel_coords, warp_to_pixel_coords\n"
        "import roma_tpu_torch.tools.crossimpl\n"
        "from roma_tpu_torch.benchmarks import pose, pose_bench, mega1500, mega1500_native, scannet, hpatches\n"
        "import roma_tpu_torch.ops.int8, roma_tpu_torch.tools.int8_drift\n"
        "from roma_tpu_torch.experiments import eval_roma_outdoor, eval_roma_indoor, eval_hpatches\n"
        "from roma_tpu_torch.experiments import eval_tiny_roma_v1_outdoor, validate_release\n"
        "from roma_tpu_torch.demo import demo_match, demo_match_tiny, demo_fundamental, demo_3D_effect\n"
        "for m in (eval_roma_outdoor, eval_roma_indoor, eval_hpatches, eval_tiny_roma_v1_outdoor, validate_release,\n"
        "          demo_match, demo_match_tiny, demo_fundamental, demo_3D_effect):\n"
        "    m.parser()\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=PKG.parent, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    top_level = []
    for f in [PKG / "serving.py", PKG / "native.py", PKG / "tools" / "crossimpl.py", *(PKG / "benchmarks").glob("*.py"),
              *(PKG / "demo").glob("*.py"), *(PKG / "experiments").glob("eval_*.py")]:
        for node in ast.parse(f.read_text()).body:
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else []
            top_level += [f"{f.name}: {n}" for n in names if n.split(".")[0] in ("cv2", "tqdm")]
    assert not top_level, top_level


def test_training_modules_load_without_h5py_cv2_or_wandb():
    """The datasets, the process-group helpers, profiling, the dense
    benchmark, the entry points and the convergence run import with JAX,
    the JAX package, h5py, OpenCV, tqdm and wandb all unimportable: h5py is
    imported by MegaDepth's depth read, tqdm by the benchmark's loop, wandb
    by the metric logger that asks for it, and ScanNet's depth is read with
    PIL."""
    code = (
        "import sys\n"
        f"for m in {BANNED + ('h5py', 'cv2', 'tqdm', 'wandb')!r}: sys.modules[m] = None\n"
        "import roma_tpu_torch.datasets, roma_tpu_torch.parallel, roma_tpu_torch.utils.profiling\n"
        "import roma_tpu_torch.benchmarks.mega_dense, roma_tpu_torch.experiments.common\n"
        "from roma_tpu_torch.experiments import train_roma_outdoor, train_roma_indoor, train_tiny_roma_v1_outdoor\n"
        "train_roma_outdoor.parser().parse_args([])\n"
        "from roma_tpu_torch.tools import convergence_run\n"
        "convergence_run.parser().parse_args([])\n"
        "from roma_tpu_torch.utils.profiling import MetricLogger\n"
        "MetricLogger(use_wandb=True).log({'loss': 1.0}, step=1)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=PKG.parent, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_no_source_reads_the_reference_tree():
    """No module of the port names a file of the reference checkout, such
    as the JAX demos' default images under its ``assets`` folder: a demo or
    the release gate takes its images as arguments."""
    assert not [f.name for f in PKG.rglob("*.py") if "reference/" + "assets" in f.read_text()]


def test_no_source_imports_jax():
    offenders = []
    for f in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{f.name}: {n}" for n in names if n.split(".")[0] in BANNED]
    assert not offenders, offenders


def test_cpu_tensors_take_the_plain_versions():
    rs = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    counts = [f.launches for f in KERNEL_WRAPPERS]

    qkv = t(2, 70, 3 * 128)
    assert torch.equal(fused_attention_packed(qkv, 2, 60), attention_packed_reference(qkv, 2, 60))
    f0, f1, flow = t(2, 9, 11, 16), t(2, 9, 11, 16), t(2, 9, 11, 2) * 0.5
    assert torch.equal(local_correlation(f0, f1, 2, flow), local_correlation_reference(f0, f1, 2, flow))
    assert torch.equal(warp_sample(f1, flow), warp_sample_reference(f1, flow))
    c = 8
    blocks = [fold_block(t(c, 1, 5, 5), t(c), t(c), t(c), t(c), t(c).abs() + 0.5, t(c, c, 1, 1), t(c))]
    x = t(2, 9, 11, c)
    assert torch.equal(fused_refiner_stack(x, blocks), refiner_stack_reference(x, blocks))
    q, k, v, g = (t(2, 3, 70, 64) for _ in range(4))
    assert torch.equal(fused_attention(q, k, v, 60), sdpa_reference(q, k, v, 60))
    grads = [torch.empty_like(q) for _ in range(3)]
    got = fused_attention_backward(q, k, v, None, None, g, *grads, n_valid=60)
    for a, b in zip(got, attention_backward_reference(q, k, v, g, 60)):
        assert torch.equal(a, b)
    miss = torch.from_numpy(rs.rand(6, 1, 64) < 0.2)
    assert torch.equal(compact_miss(miss, 64, 8), compact_miss_reference(miss, 64, 8))
    ri = lambda lo, hi, *s: torch.from_numpy(rs.randint(lo, hi, s).astype(np.int32))
    tiles = (f1, ri(-2, 12, 6, 64), ri(-2, 14, 6, 64), t(6, 64).abs() % 1, t(6, 64).abs() % 1,
             ri(0, 6, 6), ri(0, 6, 6), ri(0, 65, 6, 8, 1), t(6, 8, 16), 12, 14, 4)
    for wrapper in (warp_tiles, warp_tiles_v1):
        assert torch.equal(wrapper(*tiles), warp_tiles_reference(*tiles))
    assert torch.equal(fused_refiner_stack_packed(x, blocks * 3, cg=3), refiner_stack_reference(x, blocks * 3))
    assert torch.equal(lane_refiner_block(x, blocks[0]), wide_refiner_stack_reference(x, blocks))
    xt = x.permute(0, 1, 3, 2).contiguous()
    assert torch.equal(hcw_refiner_block(xt, blocks[0]),
                       wide_refiner_stack_reference(xt.permute(0, 1, 3, 2), blocks).permute(0, 1, 3, 2))
    win, yl, fy = t(3, 16, 5).bfloat16(), ri(-1, 16, 3, 1, 40), t(3, 1, 40).abs() % 1
    for form in ("f32", "2bf16"):
        assert torch.equal(onehot_dot(win, yl, fy, form), onehot_dot_reference(win, yl, fy))
    tab, idx = t(2, 20, 4, 16).bfloat16(), [ri(0, 9, 5), ri(0, 3, 5), ri(0, 2, 5)]
    assert torch.equal(window_sum(tab, *idx, 12, 2), window_sum_reference(tab, *idx, 12, 2))
    u8 = torch.from_numpy(rs.randint(0, 256, (2, 9, 11, 3)).astype(np.uint8))
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(resize_normalize(u8, (7, 13), dt), resize_normalize_reference(u8, (7, 13), dt))
    assert [f.launches for f in KERNEL_WRAPPERS] == counts == [0] * len(KERNEL_WRAPPERS)


def test_entry_points_default_to_the_card(monkeypatch):
    """roma_outdoor, roma_indoor, tiny_roma_v1_outdoor, train_net and
    build_net build on the card unless the caller asks for the CPU; without
    a card they raise. Offline: Tiny RoMa's released weights are not
    fetched."""
    monkeypatch.setenv("ROMA_TPU_OFFLINE", "1")
    cfg = RoMaConfig.tiny()
    builds = (lambda: roma_outdoor(config=cfg, amp=False, coarse_res=56, upsample_res=64).net,
              lambda: roma_indoor(config=cfg, amp=False, coarse_res=56, upsample_res=64).net,
              lambda: tiny_roma_v1_outdoor().net, lambda: train_net(cfg), lambda: build_net(cfg))
    for build in builds:
        if torch.cuda.is_available():
            assert next(build().parameters()).is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build()
    assert not next(build_net(cfg, "cpu").parameters()).is_cuda
