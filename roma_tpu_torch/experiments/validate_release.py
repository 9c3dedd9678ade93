"""The release gate of the port (counterpart of experiments/validate_release.py,
whose stages are at :159, :207, :225 and :305): the released checkpoint pair
through the port's loader and model, stage by stage, each with the port's
own means (the JAX package and its torch spec are not imported).

  1. **convert**: roma_outdoor.pth + dinov2_vitl14_pretrain.pth through
     ``models/zoo/convert.py``; fp16-stored tensors are counted and widened.
  2. **strict_load**: the converted keys against the port's module tree; a
     missing or an unexpected key fails, apart from DINOv2's ``mask_token``
     (no compute role in the frozen encoder).
  3. **f32_parity**: the two-pass symmetric forward at ``--res`` -> ``--up``
     in float32 (TF32 off), the kernel path on ``--device`` against the plain
     path on the CPU, on one image pair: every scale's flow within p99 < 0.1
     px, the JAX code's check. The JAX module's docstring also names "max <
     1 px", which its code does not check; neither does this one (the max is
     reported). Coarse anchors that moved more than a 64-grid cell are
     counted beside it: near-tied argmaxes (seeded weights have many) flip
     between two float32 runs, and the p99 tolerates a few.
  4. **bf16_drift**: bfloat16 (zoo.set_precision) against float32, both on
     ``--device``: the coarse anchor flip rate at scale 16 at most 0.2%.
  5. **golden_metrics**: with MEGADEPTH_ROOT set (not with ``--smoke``),
     Mega-1500 AUC@5/10/20 at 672 -> 1344 and the MegaDepth dense EPE / PCK
     against the reference's published constants, 0.5 pp apart at most.

    ROMA_WEIGHTS=roma_outdoor.pth DINOV2_WEIGHTS=dinov2_vitl14_pretrain.pth \\
        [MEGADEPTH_ROOT=data/megadepth] python -m roma_tpu_torch.experiments.validate_release

    python -m roma_tpu_torch.experiments.validate_release --smoke [--device cpu] [--config tiny]

``--smoke`` needs no weights: it fabricates the pair from the port's seeded
model (BatchNorm statistics drawn away from (0, 1)) through ``to_reference``,
stores the roma file's float32 weights as fp16 and reads both back through
``torch.load``, and runs stages 1-4 at 56 -> 64. ``--im_A`` / ``--im_B``
(or VAL_IM_A / VAL_IM_B) name the image pair; without them the pair is
seeded noise. ``--gm_bias peaked`` (the default with ``--smoke``) adds a
peaked anchor-logit field to the coarse classifier in stages 3 and 4 (the
decoder's diagnostic hook): a stand-in for a trained model's margins, which
seeded weights lack (without it, 1 of the 32 coarse cells of the tiny
smoke flips between bfloat16 and float32, over stage 4's 0.2%).

Writes the report to ``--out`` (VALIDATE_RELEASE_TORCH.json) after every
stage and exits 1 at the first stage that fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..models import RoMaConfig, RoMaNet
from ..models.zoo import build_net, convert, init_random, set_precision
from ..utils.image import imagenet_normalize, load_image, resize, to_array

# reference tests/test_mega1500.py:17-19 (the JAX module's constants)
MEGA1500_AUC = (0.6271474434923545, 0.7673889435429945, 0.8642099162282599)
# reference tests/test_mega_dense.py:16-22
MEGA_DENSE = {
    "epe": 1.581197752074192,
    "mega_pck_1": 0.8516846923828125,
    "mega_pck_3": 0.9566336059570313,
    "mega_pck_5": 0.9714825439453125,
}
AUC_TOL = 0.5 / 100  # reference README.md:151: a bigger difference is a bug
P99_PX = 0.1
FLIP_RATE = 0.002  # at most 0.2% of the coarse cells may sit near a true tie
ANCHOR_GRID = 64  # a coarse anchor cell is res / 64 px (the JAX module's)
CONFIGS = {"released": RoMaConfig, "tiny": RoMaConfig.tiny}


class GateFailure(RuntimeError):
    """A stage failed; the report on disk says which and why."""


@dataclasses.dataclass
class Report:
    path: str
    stages: dict

    def write(self):
        with open(self.path, "w") as f:
            json.dump(self.stages, f, indent=1, default=float)

    def ok(self, stage: str, **fields):
        self.stages[stage] = {"ok": True, **fields}
        self.write()

    def fail(self, stage: str, msg: str, **fields):
        self.stages[stage] = {"ok": False, "error": msg, **fields}
        self.write()
        print(f"[{stage}] FAIL: {msg}", flush=True)
        raise GateFailure(f"{stage}: {msg}")


def fabricate_pair(config: RoMaConfig, out_dir: str, seed: int = 0) -> tuple[str, str]:
    """The port's seeded model as a reference-layout pair under ``out_dir``:
    BatchNorm statistics drawn away from (0, 1), the roma file's float32
    weights stored as fp16 (as a released file may be), the DINOv2 file as
    float32. Returns the two paths."""
    net = init_random(build_net(config, "cpu"), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=gen) * 0.4 - 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) * 0.4 + 0.8)
    roma_sd, dino_sd = convert.to_reference(net)
    roma_sd = {k: v if "running" in k else v.half() for k, v in roma_sd.items()}
    paths = os.path.join(out_dir, "roma_outdoor.pth"), os.path.join(out_dir, "dinov2_vitl14_pretrain.pth")
    torch.save(roma_sd, paths[0])
    torch.save(dino_sd, paths[1])
    return paths


def read_pair(roma_path, dino_path) -> tuple[dict, dict, int]:
    """The two files -> numpy state dicts and the roma file's fp16 count."""
    sd = torch.load(roma_path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    fp16 = sum(1 for v in sd.values() if torch.is_tensor(v) and v.dtype == torch.float16)
    dino = torch.load(dino_path, map_location="cpu", weights_only=True)
    return convert.state_dict_to_numpy(sd), convert.state_dict_to_numpy(dino), fp16


def port_keys(config: RoMaConfig) -> set[str]:
    with torch.device("meta"):
        net = RoMaNet(config)
    return {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}


def load_pair_images(res: int, up: int, im_A: str | None, im_B: str | None):
    """The pair at both resolutions, the matcher's preprocessing (bicubic
    resize, ImageNet normalization), float32 NHWC; seeded noise without
    paths. Returns (four arrays, a description)."""
    if im_A and im_B:
        pils = load_image(im_A), load_image(im_B)
        prep = lambda p, r: imagenet_normalize(to_array(resize(p, (r, r))))[None].astype(np.float32)
        return [prep(p, r) for r in (res, up) for p in pils], f"{im_A} / {im_B}"
    rs = np.random.RandomState(0)
    return [(rs.randn(1, r, r, 3) * 0.5).astype(np.float32) for r in (res, res, up, up)], "seeded noise (no pair given)"


def peaked_bias(b: int, h: int, w: int, res: int, amp: float = 14.0) -> np.ndarray:
    """A peaked anchor-logit field (B, H, W, res^2) around a smooth warp, so
    the coarse argmax has no near-tie (the role of
    tools/fullres_parity.py:render_peaked_bias)."""
    ys, xs = np.meshgrid(np.linspace(-1 + 1 / h, 1 - 1 / h, h), np.linspace(-1 + 1 / w, 1 - 1 / w, w), indexing="ij")
    a = np.linspace(-1 + 1 / res, 1 - 1 / res, res)
    ay, ax = (g.reshape(-1) for g in np.meshgrid(a, a, indexing="ij"))
    out = np.empty((b, h, w, res * res), np.float32)
    sigma = 2.0 / res
    for i in range(b):
        wx = np.clip(0.9 * xs + 0.05 * (i + 1), -0.98, 0.98)
        wy = np.clip(0.9 * ys - 0.04 * (i + 1), -0.98, 0.98)
        d2 = (wx[..., None] - ax) ** 2 + (wy[..., None] - ay) ** 2
        out[i] = amp * np.exp(-d2 / (2 * sigma * sigma))
    return out


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def two_pass(net: RoMaNet, ims, res: int, up: int, bias) -> dict[str, dict[int, np.ndarray]]:
    """The symmetric coarse pass at ``res`` and the upsample pass at ``up``
    seeded with it -> {"coarse": {scale: flow}, "up": {scale: flow}}, float32
    numpy; the scale factor is the matcher's sqrt(h w) / 560."""
    dev, dt = next(net.parameters()).device, next(net.encoder.cnn.parameters()).dtype
    a, b, au, bu = (torch.from_numpy(x).to(dev, dt) for x in ims)
    gm = None if bias is None else torch.from_numpy(bias).to(dev)
    with torch.inference_mode():
        c = net(a, b, symmetric=True, scale_factor=res / 560.0, gm_logit_bias=gm)
        u = net(au, bu, symmetric=True, upsample=True, flow=c[1]["flow"], certainty=c[1]["certainty"],
                scale_factor=up / 560.0)
        return {name: {s: d["flow"].float().cpu().numpy() for s, d in out.items()}
                for name, out in (("coarse", c), ("up", u))}


def flow_stats(a: np.ndarray, b: np.ndarray, res: int) -> dict:
    d = np.abs(a - b) * res / 2
    return {"max_px": float(d.max()), "p99_px": float(np.percentile(d, 99)), "p50_px": float(np.percentile(d, 50))}


def anchor_flips(a: np.ndarray, b: np.ndarray, res: int) -> np.ndarray:
    """The coarse cells whose flow moved more than an anchor cell."""
    return (np.abs(a - b) * res / 2).max(-1) > res / ANCHOR_GRID


def loaded_net(config: RoMaConfig, state: dict, device, dtype=torch.float32) -> RoMaNet:
    net = convert.load_state(build_net(config, device), state).eval()
    return set_precision(net, dtype)


def run(args) -> dict:
    """Stages 1-5 (the module's docstring); returns the report, raises
    GateFailure at the first stage that fails (the report written first)."""
    config = CONFIGS[args.config]()
    gm_bias = args.gm_bias or ("peaked" if args.smoke else "none")
    res = args.res or (56 if args.smoke else 560)
    up = args.up or (64 if args.smoke else 864)
    report = Report(args.out, {"mode": "smoke" if args.smoke else "release", "res": [res, up],
                               "device": str(args.device), "config": args.config, "gm_bias": gm_bias})
    report.write()

    with tempfile.TemporaryDirectory() as tmp:
        # ------------------------------------------------------------ 1
        t0 = time.perf_counter()
        if args.smoke:
            roma_path, dino_path = fabricate_pair(config, tmp)
        else:
            roma_path = args.weights or os.environ.get("ROMA_WEIGHTS")
            dino_path = args.dinov2_weights or os.environ.get("DINOV2_WEIGHTS")
            if not (roma_path and dino_path):
                report.fail("convert", "--weights and --dinov2_weights (or ROMA_WEIGHTS and DINOV2_WEIGHTS) are "
                            "required, or run with --smoke")
        try:
            roma_sd, dino_sd, fp16 = read_pair(roma_path, dino_path)
            state = convert.convert_roma(roma_sd, dino_sd)
        except Exception as e:  # a file the converter cannot read fails the gate
            report.fail("convert", f"the converter raised: {e!r}")
    n_params = sum(int(np.prod(v.shape)) for v in state.values())
    report.ok("convert", params=n_params, fp16_tensors=fp16, seconds=time.perf_counter() - t0)
    print(f"[convert] ok: {n_params:,} values, {fp16} fp16 tensors widened", flush=True)

    # ---------------------------------------------------------------- 2
    own = port_keys(config)
    missing = sorted(k for k in own - state.keys() if not k.endswith(convert.DINOV2_UNUSED))
    unexpected = sorted(k for k in state.keys() - own if not k.endswith(convert.DINOV2_UNUSED))
    if missing or unexpected:
        report.fail("strict_load", f"checkpoint and module tree disagree: missing {missing[:10]}, "
                    f"unexpected {unexpected[:10]}", missing=missing, unexpected=unexpected)
    report.ok("strict_load", tensors=len(own))
    print(f"[strict_load] ok: the checkpoint covers the port's {len(own)} tensors exactly", flush=True)

    # ---------------------------------------------------------------- 3
    ims, pair = load_pair_images(res, up, args.im_A or os.environ.get("VAL_IM_A"),
                                 args.im_B or os.environ.get("VAL_IM_B"))
    bias = None
    if gm_bias == "peaked":
        h16 = res // config.dino_patch
        bias = peaked_bias(2, h16, h16, config.cls_res)
    with no_tf32():
        t0 = time.perf_counter()
        dev32 = two_pass(loaded_net(config, state, args.device), ims, res, up, bias)
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu32 = two_pass(loaded_net(config, state, "cpu"), ims, res, up, bias)
        cpu_s = time.perf_counter() - t0
    print(f"[f32_parity] {args.device} pass {dev_s:.1f} s, cpu pass {cpu_s:.1f} s", flush=True)
    per_scale = {f"{p}_s{s}": flow_stats(dev32[p][s], cpu32[p][s], r)
                 for p, r in (("coarse", res), ("up", up)) for s in dev32[p]}
    worst = max(v["p99_px"] for v in per_scale.values())
    flips = int(anchor_flips(dev32["coarse"][16], cpu32["coarse"][16], res).sum())
    cells = int(np.prod(dev32["coarse"][16].shape[:3]))
    fields = dict(pair=pair, worst_p99_px=worst, worst_max_px=max(v["max_px"] for v in per_scale.values()),
                  coarse_anchor_flips=flips, coarse_cells=cells, per_scale=per_scale,
                  device_seconds=dev_s, cpu_seconds=cpu_s)
    if not worst < P99_PX:
        report.fail("f32_parity", f"p99 {worst} px >= {P99_PX} px", **fields)
    report.ok("f32_parity", **fields)
    print(f"[f32_parity] ok: worst p99 {worst:.6f} px, {flips} of {cells} coarse anchors flipped (pair: {pair})",
          flush=True)

    # ---------------------------------------------------------------- 4
    with no_tf32():
        dev16 = two_pass(loaded_net(config, state, args.device, torch.bfloat16), ims, res, up, bias)
    drift = {}
    for p, r in (("coarse", res), ("up", up)):
        for s in dev32[p]:
            d = np.abs(dev16[p][s] - dev32[p][s]) * r / 2
            drift[f"{p}_s{s}"] = {"p99_px": float(np.percentile(d, 99)),
                                  "anchor_flip_rate": float(anchor_flips(dev16[p][s], dev32[p][s], r).mean())}
    rate = drift["coarse_s16"]["anchor_flip_rate"]
    if not rate <= FLIP_RATE:
        report.fail("bf16_drift", f"bf16 coarse anchor flip rate {rate} > {FLIP_RATE}", coarse_anchor_flip_rate=rate,
                    per_scale=drift)
    report.ok("bf16_drift", coarse_anchor_flip_rate=rate, per_scale=drift)
    print(f"[bf16_drift] ok: coarse anchor flip rate {rate}", flush=True)

    # ---------------------------------------------------------------- 5
    mroot = os.environ.get("MEGADEPTH_ROOT")
    if args.smoke or not mroot:
        report.stages["golden_metrics"] = {"ok": None, "skipped": "smoke mode" if args.smoke else
                                           "MEGADEPTH_ROOT not set"}
        report.write()
        print("[golden_metrics] skipped (no MegaDepth data)", flush=True)
    else:
        golden_metrics(report, roma_path, dino_path, mroot, args.device)
    print("VALIDATE_RELEASE_TORCH: all stages passed", flush=True)
    return report.stages


def golden_metrics(report: Report, roma_path, dino_path, mroot: str, device):
    from ..benchmarks import MegaDepthPoseEstimationBenchmark, MegadepthDenseBenchmark
    from ..models import roma_outdoor

    model = roma_outdoor(roma_path, dino_path, coarse_res=672, upsample_res=1344, device=device)
    auc = MegaDepthPoseEstimationBenchmark(mroot).benchmark(model)
    dense_model = roma_outdoor(roma_path, dino_path, coarse_res=560, upsample_res=560, upsample_preds=False,
                               symmetric=False, device=device)
    dense = MegadepthDenseBenchmark(mroot).benchmark(dense_model)
    gm = {"mega1500": auc, "mega_dense": dense}
    ok = (all(abs(auc[f"auc_{t}"] - ref) < AUC_TOL for t, ref in zip((5, 10, 20), MEGA1500_AUC))
          and all(abs(dense[k] - v) < AUC_TOL for k, v in MEGA_DENSE.items() if k in dense))
    if not ok:
        report.fail("golden_metrics", f"outside the reference's 0.5 pp: {gm}", **gm)
    report.ok("golden_metrics", **gm)
    print("[golden_metrics] ok", flush=True)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true", help="a fabricated seeded pair at 56 -> 64, no weights needed")
    p.add_argument("--weights", default=None, help="roma_outdoor.pth (else ROMA_WEIGHTS)")
    p.add_argument("--dinov2_weights", default=None, help="dinov2_vitl14_pretrain.pth (else DINOV2_WEIGHTS)")
    p.add_argument("--res", type=int, default=None, help="coarse resolution (560; 56 with --smoke)")
    p.add_argument("--up", type=int, default=None, help="upsample resolution (864; 64 with --smoke)")
    p.add_argument("--im_A", default=None, help="image A of the pair (else VAL_IM_A; else seeded noise)")
    p.add_argument("--im_B", default=None)
    p.add_argument("--gm_bias", choices=("none", "peaked"), default=None,
                   help="peaked: pin the coarse classifier with a peaked logit field in stages 3 and 4 "
                   "(the default with --smoke, whose seeded weights have no margins; else none)")
    p.add_argument("--config", choices=tuple(CONFIGS), default="released",
                   help="the architecture of the checkpoint (tiny: RoMaConfig.tiny())")
    p.add_argument("--device", default="cuda", help="the kernel path's device (stages 3 and 4)")
    p.add_argument("--out", default="VALIDATE_RELEASE_TORCH.json")
    return p


def main(argv=None) -> int:
    try:
        run(parser().parse_args(argv))
    except GateFailure:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
