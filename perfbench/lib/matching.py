"""What the matching drivers share: the matcher built from a configuration
file and the run's seed, the DINOv2 tokens kept for the check, and the
comparison of kept answers with the plain reference.

The numbers, each the worst over the kept answers (the mix's ``limits``
name those compared; the rest are kept as readings):

* ``warp_p10_px`` ... ``warp_p99_px``: percentiles, over every pixel of both
  directions, of the distance between the program's warp target and the
  reference's, in pixels of the output canvas; ``warp_far_share``: the
  share of those pixels more than 5 pixels apart;
* ``cert_p50``, ``cert_p90``, ``cert_p99``: percentiles of the absolute
  difference of the certainties;
* ``dino_mlp0_rel_rms``, ``dino_first_rel_rms``, ``dino_rel_rms``: the rms
  difference of the MLP output of DINOv2's first block, of that block's
  output, and of DINOv2's output tokens, over the reference's rms;
* ``kpt_p10_px``, ``kpt_p50_px``, ``kpt_p90_px`` (with sampled
  correspondences): percentiles of the distance, in pixels of the image,
  between a sampled correspondence's point in one image and where the
  reference's warp sends its point in the other.

Seeded random weights leave the coarse classifier's 4096-way argmax
near-tied, so that between any two precisions some anchors fall the other
way and their pixels move by tens of pixels. Both sides therefore add one
peaked anchor-logit field (:func:`peaked_bias`) to the coarse logits, the
program through its ``gm_logit_bias`` hook on every request of the run:
the argmax then has a margin, and the whole warp can be compared. The
traffic is untouched.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..reference import roma as R
from .harness import Compared
from .traffic import sub_seed

WEIGHT_STREAM = 0


def port_config(cfg: dict, control: bool):
    """The program's RoMaConfig for a configuration file; ``control`` turns
    on the program's own int8 serving path (the precision below bf16)."""
    from roma_tpu_torch import RoMaConfig

    fields = {f.name for f in dataclasses.fields(RoMaConfig)}
    kw = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v
          for k, v in cfg["model"].items() if k in fields}
    if control:
        kw.update(vit_int8=True, refiner_int8=True)
    return RoMaConfig(**kw)


def weights(run) -> dict:
    """The run's seeded float32 weights, made on the run's device."""
    return R.make_weights(run.cfg["model"], sub_seed(run.seed, WEIGHT_STREAM), run.device)


def peaked_bias(cfg: dict, device, hw=None, amp: float = 14.0) -> torch.Tensor:
    """A peaked anchor-logit field (1, H16, W16, cls_res^2) around a smooth
    warp (x, y) -> (0.9 x + 0.05, 0.9 y - 0.04) at the coarse canvas ``hw``
    (the configuration's ``coarse_res`` by default), float32: the same field
    for every row of a batch, added to the coarse logits on both sides."""
    h, w = (n // cfg["dino_patch"] for n in (hw or cfg["coarse_res"]))
    res = cfg["cls_res"]
    lin = lambda n: torch.linspace(-1 + 1 / n, 1 - 1 / n, n, dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(lin(h), lin(w), indexing="ij")
    ay, ax = (g.reshape(-1) for g in torch.meshgrid(lin(res), lin(res), indexing="ij"))
    wx = (0.9 * xs + 0.05).clamp(-0.98, 0.98)
    wy = (0.9 * ys - 0.04).clamp(-0.98, 0.98)
    d2 = (wx[..., None] - ax) ** 2 + (wy[..., None] - ay) ** 2
    sigma = 2.0 / res
    return (amp * torch.exp(-d2 / (2 * sigma * sigma))).float()[None]


def build_matcher(run):
    """roma_outdoor's matcher at the configuration's canvas, on the run's
    seeded weights: the net built on the meta device and filled, cast to
    the serving dtype with the float32 islands (``set_precision``); every
    ``match`` call adds :func:`peaked_bias` to the coarse logits."""
    from roma_tpu_torch.models.roma import RegressionMatcher
    from roma_tpu_torch.models.zoo import build_net, set_precision

    m = run.cfg["model"]
    net = build_net(port_config(run.cfg, run.control), run.device)
    with torch.no_grad():
        net.load_state_dict(weights(run))
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[run.cfg["dtype"]]
    set_precision(net, dtype)
    matcher = RegressionMatcher(net, h=m["coarse_res"][0], w=m["coarse_res"][1],
                                upsample_res=tuple(m["upsample_res"]), symmetric=True, upsample_preds=True,
                                attenuate_cert=True, seed=sub_seed(run.seed, WEIGHT_STREAM + 1))
    matcher.match = functools.partial(matcher.match, gm_logit_bias=peaked_bias(m, run.device))
    if run.fault is not None:
        plant(run.fault, matcher)
    return matcher


FAULTS = ("shifted_warp", "scaled_cert")


def plant(fault: str, matcher):
    """Break the timed path underneath, for the tests of the check:
    "shifted_warp" moves every warp target by one pixel of the canvas where
    the warp is assembled (an answer altered where it is produced);
    "scaled_cert" scales every certainty by 0.9 where it is assembled."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; the faults are {FAULTS}")
    assemble = matcher._assemble

    def altered(flow, certainty, low):
        if fault == "shifted_warp":
            return assemble(flow + 2.0 / flow.shape[2], certainty, low)
        warp, cert = assemble(flow, certainty, low)
        return warp, cert * 0.9

    matcher._assemble = altered


class KeepTokens:
    """Forward hooks on the program's DINOv2, on its first block and on that
    block's MLP that hand each output to ``sink(name, out)`` while ``sink``
    is set (the kept answers' tokens: "dinov2", "dinov2_block0",
    "dinov2_mlp0")."""

    def __init__(self, matcher):
        self.sink = None
        dino = matcher.net.encoder.dinov2
        self.handles = [dino.register_forward_hook(lambda m, a, out: self._hook("dinov2", out)),
                        dino.blocks[0].register_forward_hook(lambda m, a, out: self._hook("dinov2_block0", out)),
                        dino.blocks[0].mlp.register_forward_hook(lambda m, a, out: self._hook("dinov2_mlp0", out))]

    def _hook(self, name, out):
        if self.sink is not None:
            self.sink(name, out)

    def remove(self):
        for h in self.handles:
            h.remove()


def _pixels(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack(((flow[..., 0] + 1) * w / 2, (flow[..., 1] + 1) * h / 2), dim=-1)


def _lookup(warp_half: torch.Tensor, pts_px: torch.Tensor, h_img: int, w_img: int) -> torch.Tensor:
    """The warp target (normalized) at each point of an image of (h_img,
    w_img) pixels: the nearest pixel of the (H, W) warp."""
    h, w = warp_half.shape[:2]
    x = ((pts_px[:, 0] / w_img) * w).floor().long().clamp(0, w - 1)
    y = ((pts_px[:, 1] / h_img) * h).floor().long().clamp(0, h - 1)
    return warp_half[y, x]


def _rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def _quantiles(x: torch.Tensor, qs) -> list[float]:
    return torch.quantile(x.flatten().float()[:: max(1, x.numel() // 2 ** 24)],
                          torch.tensor(qs, device=x.device)).tolist()


def compare_answer(got: dict, ref_warp: torch.Tensor, ref_cert: torch.Tensor, ref_keep: dict,
                   img_hw: tuple[int, int]) -> dict:
    """The numbers of one kept answer. ``got``: "warp" (H, 2W, 4), "certainty"
    (H, 2W), "dinov2" (2, h, w, D), "dinov2_block0" (2, N, D) and optionally
    "kpts" ((N, 2) in A, (N, 2) in B, image pixels); the reference's warp
    (H, 2W, 4), certainty, and its tokens under the same names."""
    h, w2 = ref_warp.shape[:2]
    w = w2 // 2
    gw, rw = got["warp"].float(), ref_warp.float()
    targets = lambda x: torch.cat((x[:, :w, 2:], x[:, w:, :2]), dim=1)
    d = (_pixels(targets(gw), h, w) - _pixels(targets(rw), h, w)).norm(dim=-1)
    qs = (10, 50, 90, 99)
    out = {f"warp_p{q}_px": v for q, v in zip(qs, _quantiles(d, [q / 100 for q in qs]))}
    out["warp_far_share"] = float((d > 5.0).float().mean())
    dc = (got["certainty"].float() - ref_cert.float()).abs()
    out.update({f"cert_p{q}": v for q, v in zip((50, 90, 99), _quantiles(dc, [0.5, 0.9, 0.99]))})
    out.update(dino_first_rel_rms=_rel_rms(got["dinov2_block0"], ref_keep["dinov2_block0"]),
               dino_mlp0_rel_rms=_rel_rms(got["dinov2_mlp0"], ref_keep["dinov2_mlp0"]),
               dino_rel_rms=_rel_rms(got["dinov2"], ref_keep["dinov2"]))
    if "kpts" in got:
        ha, wa = img_hw
        k_a, k_b = (k.to(rw.device).float() for k in got["kpts"])
        a2b = _pixels(_lookup(rw[:, :w, 2:], k_a, ha, wa), ha, wa)  # same size A and B
        b2a = _pixels(_lookup(rw[:, w:, :2], k_b, ha, wa), ha, wa)
        e = torch.minimum((a2b - k_b).norm(dim=-1), (b2a - k_a).norm(dim=-1))
        out["kpt_p10_px"], out["kpt_p50_px"], out["kpt_p90_px"] = _quantiles(e, [0.1, 0.5, 0.9])
    return out


@torch.no_grad()
def check_kept(run, kept: list[dict]) -> list[Compared]:
    """Run the plain float32 reference on each kept answer's pair and compare;
    the worst reading of each number against the mix's limit."""
    missing = [Compared("answers_missing", float(run.mix["keep"] - len(kept)), 0.0)] if len(kept) < run.mix["keep"] else []
    if not kept:
        return missing
    R.strict_float32()
    m = run.cfg["model"]
    ref = R.RoMaReference(m, weights(run))
    bias = peaked_bias(m, run.device)
    chw, uhw = tuple(m["coarse_res"]), tuple(m["upsample_res"])
    worst: dict[str, float] = {}
    for k in kept:
        a, b = k["pair"]
        ins = [R.prepare(p, hw, run.device) for hw in (chw, uhw) for p in (a, b)]
        keep = {}
        rw, rc = R.match(ref, *ins, chw, uhw, keep=keep, gm_logit_bias=bias)
        img_hw = (a.size[1], a.size[0])
        nums = compare_answer(k, rw[0], rc[0], keep, img_hw)
        for n, v in nums.items():
            worst[n] = max(worst.get(n, -math.inf), v)
        del rw, rc, keep
    run.records["check_detail"] = dict(worst, answers=len(kept))
    limits = run.mix["limits"]
    return [Compared(n, worst[n], float(limits[n])) for n in limits if n in worst] + missing
