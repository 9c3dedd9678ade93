"""The yardstick's arithmetic: the card's peaks, each hand-written kernel's
least time from the shapes it is launched at, the launches a request or a
training step makes, and the model's operations counted on the plain
reference.

The kernels' bounds are frozen copies of chip_smoke.py's: each input read
once and each output written once over the memory rate, against the
operations over the peak of the unit that runs them (the tensor cores for
bf16 products, the CUDA cores for the rest); the larger of the two is the
kernel's least time.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


@dataclass(frozen=True)
class Launch:
    """One kernel launch: the port's kernel letter and the least time of its work."""

    kernel: str
    bytes: float
    ops: float          # at ``peak``
    peak: float = PEAK_BF16
    f32_ops: float = 0.0  # on the CUDA cores beside them

    def bound_s(self) -> float:
        if self.peak == PEAK_F32:
            ops_s = (self.ops + self.f32_ops) / PEAK_F32
        else:
            ops_s = max(self.ops / self.peak, self.f32_ops / PEAK_F32)
        return max(self.bytes / HBM_BYTES_PER_S, ops_s)


def attention_fwd(b: int, n: int, c: int, es: int = 2) -> Launch:
    """Kernel A, packed qkv (B, N, 3C) in, (B, N, C) out: two products a head."""
    return Launch("A", b * n * 4 * c * es, 4 * b * n * n * c)


def attention_bwd(b: int, heads: int, n: int, c: int, es: int = 2) -> Launch:
    """Kernel E: q, k, v, out, dout in, dq, dk, dv out, the float32 row
    statistics; five products a head."""
    return Launch("E", 8 * b * n * c * es + 4 * b * heads * n, 10 * b * n * n * c)


def local_corr(b: int, h: int, w: int, c: int, r: int, es: int = 2) -> Launch:
    """Kernel B: f0, f1 and the warp in, (2r+1)^2 taps out; a C-long dot
    product at each of the (2r+2)^2 integer taps, the bilinear fold in float32."""
    npx = b * h * w
    return Launch("B", npx * (2 * c * es + 8 + (2 * r + 1) ** 2 * es), npx * 2 * c * (2 * r + 2) ** 2,
                  PEAK_BF16 if es == 2 else PEAK_F32, npx * 8 * (2 * r + 1) ** 2)


def warp_sample(b: int, hq: int, wq: int, c: int, es: int = 2) -> Launch:
    """Kernel C: the source read once (as large as the output here) and the
    float32 flow in, the samples out; four taps of C channels a query."""
    npx = b * hq * wq
    return Launch("C", npx * (2 * c * es + 8), 8 * npx * c, PEAK_F32)


def refiner_block(b: int, h: int, w: int, c: int, k: int = 5, es: int = 2) -> Launch:
    """Kernel D, one folded block: its input and output once and its float32
    weights; the CxC pointwise product on the tensor cores (bf16), the KxK
    depthwise on the CUDA cores."""
    npx = b * h * w
    nbytes = 2 * npx * c * es + 4 * (k * k * c + c * c + 2 * c)
    return Launch("D", nbytes, 2 * npx * c * c, PEAK_BF16 if es == 2 else PEAK_F32, 2 * npx * k * k * c)


def _scales(cfg: dict, key: str) -> dict[int, int]:
    return {int(s): int(v) for s, v in cfg[key]}


def refiner_width(cfg: dict, s: int) -> int:
    r = _scales(cfg, "corr_radius")[s]
    return 2 * _scales(cfg, "proj_out")[s] + _scales(cfg, "disp_emb")[s] + ((2 * r + 1) ** 2 if r else 0)


KERNEL_D_MAX_C = 32  # the widest refiner stack the program runs on Kernel D


def match_launches(cfg: dict, pairs: int, coarse_hw, up_hw) -> list[Launch]:
    """The launches of one symmetric two-pass match of ``pairs`` pairs:
    A in every DINOv2 block (A and B images) and every decoder block (both
    directions), B at every scale with a local correlation, C at every
    scale, D for each block of a stack at most 32 wide, in both passes."""
    out = []
    p = cfg["dino_patch"]
    gh, gw = coarse_hw[0] // p, coarse_hw[1] // p
    out += [attention_fwd(2 * pairs, gh * gw + 1, cfg["dino_dim"])] * cfg["dino_depth"]
    dec = cfg["gp_dim"] + _scales(cfg, "proj_out")[16]
    out += [attention_fwd(2 * pairs, gh * gw, dec)] * cfg["decoder_depth"]
    proj, rad = _scales(cfg, "proj_out"), _scales(cfg, "corr_radius")
    for hw, scales in ((coarse_hw, (16, 8, 4, 2, 1)), (up_hw, (8, 4, 2, 1))):
        for s in scales:
            h, w = (gh, gw) if s == 16 else (hw[0] // s, hw[1] // s)
            if rad[s]:
                out.append(local_corr(2 * pairs, h, w, proj[s], rad[s]))
            out.append(warp_sample(2 * pairs, h, w, proj[s]))
            if refiner_width(cfg, s) <= KERNEL_D_MAX_C:
                out += [refiner_block(2 * pairs, h, w, refiner_width(cfg, s))] * (cfg["hidden_blocks"] + 1)
    return out


def train_launches(cfg: dict, batch: int, hw, remat: bool) -> list[Launch]:
    """The launches of one training step: A in DINOv2's blocks (A and B
    images) and in the decoder's, whose forward runs again in the backward
    under remat; E once a decoder block. B, C and D give way to their plain
    versions in training."""
    p = cfg["dino_patch"]
    n = (hw[0] // p) * (hw[1] // p)
    dec = cfg["gp_dim"] + _scales(cfg, "proj_out")[16]
    return ([attention_fwd(2 * batch, n + 1, cfg["dino_dim"])] * cfg["dino_depth"]
            + [attention_fwd(batch, n, dec)] * ((2 if remat else 1) * cfg["decoder_depth"])
            + [attention_bwd(batch, cfg["decoder_heads"], n, dec)] * cfg["decoder_depth"])


# the port's kernels by a part of their __global__ function's name, as the
# profiler shows them
KERNEL_NAMES = {"A": ("attn_fwd",), "E": ("attn_bwd",), "B": ("local_corr",),
                "C": ("warp_vec", "warp_reg", "warp_scalar"), "D": ("refiner_block",)}


def kernel_of(name: str) -> str | None:
    return next((k for k, subs in KERNEL_NAMES.items() if any(s in name for s in subs)), None)


# ---------------------------------------------------------------------------
# the model's operations, counted on the plain reference
# ---------------------------------------------------------------------------

def _reference_digest(cfg: dict, what: str) -> str:
    ref = Path(__file__).resolve().parents[1] / "reference"
    h = hashlib.sha256(json.dumps([cfg, what], sort_keys=True).encode())
    for f in sorted(ref.glob("*.py")):
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def model_flops(cfg: dict, what: str, cache_dir: Path) -> float:
    """Operations (2 a multiply-add) of one pair's symmetric two-pass match
    (``what`` = "match", at cfg's "coarse_res" -> "upsample_res") or of one
    sample's training forward and backward without recompute ("train", at
    cfg's "train_res"), counted by torch's FlopCounterMode over the plain
    reference on the meta device. Cached in ``cache_dir`` by the
    configuration and the reference's sources."""
    key = _reference_digest(cfg, what)
    path = cache_dir / f"flops_{what}_{key}.json"
    if path.is_file():
        return float(json.loads(path.read_text())["flops"])
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import roma as R
    from ..reference import train as RT

    weights = {k: torch.empty(shape, device="meta", dtype=torch.long if kind == "count" else torch.float32)
               for k, shape, kind in R.param_specs(cfg)}
    counter = FlopCounterMode(display=False)
    if what == "match":
        ch, cw = cfg["coarse_res"]
        uh, uw = cfg["upsample_res"]
        ins = [torch.empty(1, h, w, 3, device="meta") for h, w in ((ch, cw), (ch, cw), (uh, uw), (uh, uw))]
        with counter:
            R.match(R.RoMaReference(cfg, weights), *ins, (ch, cw), (uh, uw))
    else:
        h, w = cfg["train_res"]
        for k in weights:
            if not k.startswith("encoder.dinov2") and weights[k].is_floating_point() and "running" not in k:
                weights[k].requires_grad_(True)
        batch = {"im_A": torch.empty(1, h, w, 3, device="meta"), "im_B": torch.empty(1, h, w, 3, device="meta"),
                 "im_A_depth": torch.empty(1, h, w, device="meta"), "im_B_depth": torch.empty(1, h, w, device="meta"),
                 "T_1to2": torch.empty(1, 4, 4, device="meta"), "K1": torch.empty(1, 3, 3, device="meta"),
                 "K2": torch.empty(1, 3, 3, device="meta")}
        params = [t for t in weights.values() if t.requires_grad]
        with counter:
            net = R.RoMaReference(cfg, weights, train=True, recompute=False)
            loss = RT.robust_loss(net.forward(batch["im_A"], batch["im_B"]), batch)
            torch.autograd.grad(loss, params, allow_unused=True)
    flops = float(counter.get_total_flops())
    cache_dir.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"flops": flops, "what": what}))
    return flops


def untraced_rate(records: dict) -> float | None:
    """Units (pairs, samples) a second over the window with the traced
    stretch, which the profiler slows, left out of both."""
    units = records.get("units", 0) - records.get("traced_units", 0)
    t = records.get("window_s", 0.0) - records.get("traced_s", 0.0)
    return units / t if units > 0 and t > 0 else None


# the program's launch counters, by kernel letter
WRAPPERS = {"A": "fused_attention_packed", "B": "local_correlation", "C": "warp_sample",
            "D": "fused_refiner_stack", "E": "fused_attention_backward"}


def kernels_roofline(records: dict, per_unit: list[Launch]) -> float | None:
    """100 * the least time of the traced launches over their device time.
    ``per_unit``: the launches of one unit of work (a batch, a step);
    ``records["traced_rounds"]``: the units in the traced stretch;
    ``records["traced_launches"]``: the program's counters over it;
    ``records["trace"]["kernels"]``: device seconds by kernel name. None
    unless every kernel's counter is exactly its launches a unit times the
    traced units and the trace shows each of them: a count that the launch
    arithmetic does not predict is a miscount or a changed path, and no
    share is read from it."""
    rounds = records.get("traced_rounds") or 0
    deltas = records.get("traced_launches") or {}
    kernels = (records.get("trace") or {}).get("kernels") or {}
    if rounds <= 0:
        return None
    bound = took = 0.0
    for letter in sorted({ln.kernel for ln in per_unit}):
        mine = [ln for ln in per_unit if ln.kernel == letter]
        t = sum(sec for name, (sec, _) in kernels.items() if kernel_of(name) == letter)
        if deltas.get(WRAPPERS[letter]) != len(mine) * rounds or t <= 0:
            return None
        bound += sum(ln.bound_s() for ln in mine) * rounds
        took += t
    return 100.0 * bound / took
