"""The synthetic two-view scenes of the cross-implementation AUC capstone
and its seeded weights (the port's own copy of the geometry and bias half of
tools/crossimpl_auc.py; NumPy and torch only).

Each scene is a smooth height-field surface seen by two cameras with a known
relative pose; its ground-truth warps in both directions come from exact
ray / surface intersection (``gt_warp``). ``render_gt_bias`` turns a scene's
warp into a scale-16 anchor-logit bias, solved against the model's own
``cls_logits`` so that the coarse classifier decodes the ground truth; the
matcher takes it through its ``gm_logit_bias`` hook. Every other module runs
on seeded random weights (``capstone_net``), with the refiners' flow rows
scaled by ``refiner_flow_gain``. ``PrecomputedMatcher`` hands stored warps to
the pose benchmark (``benchmarks.pose_bench``) with the port's sampling.

Used by tests/torch_crossimpl.py (the port against the JAX package on the
CPU, which writes CROSSIMPL_AUC_TORCH.json) and by chip_smoke.py's eval
phase (the same scenes on the card).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..benchmarks.pose_bench import PosePair
from ..models.config import RoMaConfig
from ..models.roma import RegressionMatcher
from ..models.zoo import build_net, init_random, set_precision
from ..ops import balanced_sample

# the capstone's regime (tools/crossimpl_auc.py:run_crossimpl): 3 scenes, a
# logit-aware bias of amplitude 60, 5 repeats of 5000 samples
N_SCENES, BIAS_AMP, REPEATS, SAMPLE_N = 3, 60.0, 5, 5000


@dataclasses.dataclass
class Scene:
    """One synthetic evaluation scene (all geometry in camera-A frame)."""

    K1: np.ndarray  # (3,3)
    K2: np.ndarray
    R: np.ndarray   # X_B = R @ X_A + t
    t: np.ndarray
    hw_A: tuple[int, int]
    hw_B: tuple[int, int]
    amp: float      # surface relief amplitude
    phase: float    # surface phase (varies per scene)

    def surface_z(self, x, y):
        """Height field z = f(x, y) in the A frame — smooth, non-planar."""
        return (
            5.0
            + self.amp * np.sin(0.45 * x + self.phase)
            + 0.8 * self.amp * np.cos(0.6 * y - 0.7 * self.phase)
        )


def make_scene(idx: int, hw: tuple[int, int]) -> Scene:
    """``hw`` must be the resolution the benchmark's keypoints live at (the
    upsample resolution) so K matches the to-pixel scale.

    The baseline is ~15% of the scene depth (|t| ~ 0.8 at z ~ 5). The first
    cut of these scenes used a 5% baseline, and the essential-matrix problem
    was measurably ill-conditioned there: the native estimator's pose error
    on a FIXED 5000-match set varied 1.5-73 degrees across RANSAC seeds.
    At 15% the translation direction is strongly observable and the
    estimator's seed spread collapses below 0.1 degrees in the low-noise
    match regime this tool runs in (see run_crossimpl). ~80% of each view
    still maps inside the other; out-of-view targets are cert-zeroed
    identically on both sides."""
    h, w = hw
    f = 0.95 * max(h, w) * (1.0 + 0.05 * (idx % 3))
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    ay = 0.04 + 0.01 * idx           # yaw
    ax = 0.012 * ((idx % 2) * 2 - 1)  # slight pitch, alternating sign
    cy, sy = np.cos(ay), np.sin(ay)
    cx, sx = np.cos(ax), np.sin(ax)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    R = Rx @ Ry
    t = np.array([0.75 + 0.09 * idx, 0.24, 0.12])
    # relief ~24% of depth: strong non-planarity + parallax kill the
    # rotation/translation near-ambiguity that shallow scenes leave in the
    # estimator (residual 0.1-0.6 deg wander in the weakly-observable
    # direction at the old amp=0.5)
    return Scene(K1=K, K2=K.copy(), R=R, t=t, hw_A=hw, hw_B=hw,
                 amp=1.2, phase=0.9 * idx)


def _raycast(scene: Scene, dirs: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """Intersect rays X = origin + lam * dirs with z = f(x, y).

    Fixed-point on lam: lam <- (f(x, y) - o_z) / d_z. The surface relief
    (|df| <= ~0.5) is small against z ~ 5 and rays are near-axial, so this
    converges geometrically; 25 iterations leave the residual below 1e-9.
    Returns the 3D intersection points, shape of ``dirs``.
    """
    dz = dirs[..., 2]
    lam = (5.0 - origin[2]) / dz
    for _ in range(25):
        x = origin[0] + lam * dirs[..., 0]
        y = origin[1] + lam * dirs[..., 1]
        lam = (scene.surface_z(x, y) - origin[2]) / dz
    return origin + lam[..., None] * dirs


def gt_warp(scene: Scene, pts_norm: np.ndarray, direction: str) -> np.ndarray:
    """Exact warp at normalized points [-1,1]^2 -> normalized target coords.

    direction "AtoB": cast rays from camera A (identity pose), project the
    surface points into B. "BtoA": rays from camera B expressed in the A
    frame (d_A = R^T d_B, origin -R^T t), project into A.
    """
    if direction == "AtoB":
        K_src, K_dst, (h, w) = scene.K1, scene.K2, scene.hw_A
        (hd, wd) = scene.hw_B
    else:
        K_src, K_dst, (h, w) = scene.K2, scene.K1, scene.hw_B
        (hd, wd) = scene.hw_A
    # normalized [-1,1] -> pixel centers (the matcher's convention:
    # x_px = w/2 * (x + 1), i.e. -1+1/w maps to pixel center 0.5)
    px = np.stack(
        (
            (pts_norm[..., 0] + 1) * w / 2,
            (pts_norm[..., 1] + 1) * h / 2,
            np.ones_like(pts_norm[..., 0]),
        ),
        axis=-1,
    )
    rays = px @ np.linalg.inv(K_src).T
    if direction == "AtoB":
        X = _raycast(scene, rays, np.zeros(3))
        Xd = X @ scene.R.T + scene.t
    else:
        origin = -scene.R.T @ scene.t
        X = _raycast(scene, rays @ scene.R, origin)  # d_A = R^T d_B
        Xd = X
    proj = Xd @ K_dst.T
    uv = proj[..., :2] / proj[..., 2:3]
    return np.stack(
        (2 * uv[..., 0] / wd - 1, 2 * uv[..., 1] / hd - 1), axis=-1
    )


def _decode_cls(logits: np.ndarray, cls_res: int) -> np.ndarray:
    """numpy mirror of ops/cls_to_flow.py cls_to_flow_refine (softmax over
    all anchors, argmax + clamped {x±1, y±res} cross, prob-weighted anchor
    mean). logits (..., cls_res^2) -> flow (..., 2)."""
    c = cls_res * cls_res
    anchors1 = np.linspace(-1 + 1 / cls_res, 1 - 1 / cls_res, cls_res)
    a_y, a_x = np.meshgrid(anchors1, anchors1, indexing="ij")
    axy = np.stack((a_x.reshape(-1), a_y.reshape(-1)), -1)  # (C, 2) xy
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z, dtype=np.float64)
    p /= p.sum(-1, keepdims=True)
    mode = p.argmax(-1)
    idx = np.stack(
        (mode - 1, mode, mode + 1, mode - cls_res, mode + cls_res), -1
    ).clip(0, c - 1)
    np_ = np.take_along_axis(p, idx, axis=-1)  # (..., 5)
    nxy = axy[idx]                             # (..., 5, 2)
    return (np_[..., None] * nxy).sum(-2) / np_.sum(-1, keepdims=True)


def render_gt_bias(scene: Scene, grid_hw: tuple[int, int], cls_res: int = 64,
                   amp: float = 14.0, sigma_cells: float = 1.0,
                   model_logits: np.ndarray | None = None,
                   verbose: bool = False) -> np.ndarray:
    """GT warp -> (2, H16, W16, cls_res^2) peaked logits for the symmetric
    pass (batch el 0: A->B, el 1: B->A). Anchor coords follow
    cls_to_flow_refine: linspace(-1+1/res, 1-1/res).

    ``model_logits`` (2, gh, gw, cls_res^2): the model's own scale-16
    cls_logits (bias-independent — they are computed before the hook adds
    the bias). When given, the bias is DESIGNED rather than Gaussian:
    bias = T - model_logits, where T places ln-weights on the target cell's
    decode cross ({m, m±1, m±res}) such that the prob-weighted anchor mean
    equals the GT warp exactly. A plain GT-centered Gaussian decodes with
    ~0.2-cell systematic error (the 5-anchor mean is a biased sub-cell
    estimator, and at useful amps the softmax is a near-step function of
    the center — the inverse problem is stiff) plus ~0.1 cell of
    model-logit perturbation, i.e. ~1.5-3 px at 864 — noisy enough to make
    0.5 px-threshold RANSAC chaotic. The designed bias brings the decoded
    coarse flow to <1e-3 px of GT on the torch side, while the jax side
    decodes T + (L_jax - L_torch): any genuine cross-impl divergence in the
    GP/decoder path still lands in the metric. Both implementations receive
    the IDENTICAL bias array.

    Out-of-grid targets clamp to the border anchors (cell offsets clipped
    toward the interior), so ~20% of each view becomes border-pinned
    outliers — identically on both sides, absorbed by RANSAC exactly as the
    old Gaussian construction's out-of-view cells were."""
    gh, gw = grid_hw
    ys, xs = np.meshgrid(
        np.linspace(-1 + 1 / gh, 1 - 1 / gh, gh),
        np.linspace(-1 + 1 / gw, 1 - 1 / gw, gw),
        indexing="ij",
    )
    pts = np.stack((xs, ys), axis=-1)
    anchors = np.linspace(-1 + 1 / cls_res, 1 - 1 / cls_res, cls_res)
    ay, ax = np.meshgrid(anchors, anchors, indexing="ij")
    ax, ay = ax.reshape(-1), ay.reshape(-1)
    sigma = sigma_cells * 2.0 / cls_res
    res = cls_res
    out = np.empty((2, gh, gw, res * res), np.float32)
    for bi, direction in enumerate(("AtoB", "BtoA")):
        wxy = gt_warp(scene, pts, direction)
        if model_logits is None:
            d2 = (wxy[..., 0:1] - ax) ** 2 + (wxy[..., 1:2] - ay) ** 2
            out[bi] = amp * np.exp(-d2 / (2 * sigma * sigma))
            continue
        # --- designed logit field T: decode(T) == wxy exactly ---
        # nearest anchor per axis; sub-cell offsets in cell units
        kx = np.clip(np.round((wxy[..., 0] + 1) * res / 2 - 0.5), 0, res - 1)
        ky = np.clip(np.round((wxy[..., 1] + 1) * res / 2 - 0.5), 0, res - 1)
        dx = (wxy[..., 0] - (-1 + (2 * kx + 1) / res)) * res / 2
        dy = (wxy[..., 1] - (-1 + (2 * ky + 1) / res)) * res / 2
        # clip toward the interior: border cells lose the outward arm
        dx = np.clip(dx, np.where(kx == 0, 0, -0.5),
                     np.where(kx == res - 1, 0, 0.5))
        dy = np.clip(dy, np.where(ky == 0, 0, -0.5),
                     np.where(ky == res - 1, 0, 0.5))
        # project onto the decode's representable set. argmax must stay at
        # the center anchor (w_c >= mu * max arm, mu = e^0.05 margin so
        # cross-impl logit deltas ~1e-3 cannot flip it), which bounds the
        # offset region by mu*|major| + |dx| + |dy| <= 1 per axis — targets
        # near cell CORNERS are unrepresentable by the 5-point cross (an
        # inherent property of the reference decode, reference
        # utils.py:300-322; trained refiners correct it). Euclidean
        # projection: worst case (0.5, 0.5) -> ~(1/3, 1/3), a 0.24-cell
        # (3.2 px at 864) high-frequency error confined to corner loci.
        mu = np.exp(0.05)
        sx, sy = np.sign(dx), np.sign(dy)
        px_, py_ = np.abs(dx), np.abs(dy)
        for _ in range(2):  # two half-space projections + vertex fallback
            viol = (mu + 1) * px_ + py_ - 1
            scale = (mu + 1) ** 2 + 1
            px_ = np.where(viol > 0, px_ - (mu + 1) * viol / scale, px_)
            py_ = np.where(viol > 0, py_ - viol / scale, py_)
            px_, py_ = np.maximum(px_, 0), np.maximum(py_, 0)
            px_, py_ = py_, px_  # swap axes to apply the symmetric constraint
        both = ((mu + 1) * px_ + py_ > 1) & (px_ + (mu + 1) * py_ > 1)
        vtx = 1.0 / (mu + 2)
        px_ = np.where(both, vtx, px_)
        py_ = np.where(both, vtx, py_)
        dx, dy = sx * px_, sy * py_
        m = (ky * res + kx).astype(np.int64)
        w_l, w_r = np.maximum(-dx, 0), np.maximum(dx, 0)
        w_u, w_d = np.maximum(-dy, 0), np.maximum(dy, 0)
        w_c = 1.0 - (w_l + w_r + w_u + w_d)
        T = np.zeros((gh, gw, res * res), np.float64)
        lw = lambda w: amp + np.log(np.maximum(w, 1e-9))
        # center written LAST so it wins border-clip index collisions
        for off, wgt in ((-1, w_l), (1, w_r), (-res, w_u), (res, w_d),
                         (0, w_c)):
            np.put_along_axis(
                T, np.clip(m + off, 0, res * res - 1)[..., None],
                lw(wgt)[..., None], axis=-1,
            )
        out[bi] = T - model_logits[bi].astype(np.float64)
        if verbose:
            dec = _decode_cls(model_logits[bi].astype(np.float64) + out[bi],
                              res)
            inview = (np.abs(wxy) < 1.0).all(-1)
            r = np.abs(dec - wxy).max(-1)[inview].max() * res / 2
            print(f"  bias design [{direction}]: max in-view decode "
                  f"residual {r:.5f} cells", flush=True)
    return out


def scene_images(idx: int, coarse: int, up: int):
    """Deterministic pseudo-image content per scene — identical arrays feed
    both implementations; the geometry lives in the bias, the images only
    drive the data-dependent module numerics."""
    rs = np.random.RandomState(100 + idx)
    mk = lambda r: (rs.randn(1, r, r, 3) * 0.5).astype(np.float32)
    return mk(coarse), mk(coarse), mk(up), mk(up)


def capstone_net(seed: int = 0, refiner_flow_gain: float = 0.02, device="cpu", amp: bool = False,
                 config: RoMaConfig | None = None) -> torch.nn.Module:
    """The capstone's seeded weights on ``device``, in eval mode: drawn on
    the CPU (a card draws other numbers) by ``init_random(seed)``, the
    BatchNorm running stats perturbed from a CPU generator (mean U(-0.2,
    0.2), var U(0.8, 1.2), as tools/crossimpl_auc.py:459-462), the flow rows
    (0:2) of every refiner's out_conv scaled by ``refiner_flow_gain``. float32,
    or with ``amp`` the production bf16 path (``set_precision``, tanh GELU in
    DINOv2, as ``roma_outdoor(amp=True)``)."""
    config = dataclasses.replace(config or RoMaConfig(), vit_gelu_tanh=amp)
    net = init_random(build_net(config, "cpu"), seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
        if refiner_flow_gain != 1.0:
            for r in net.decoder.conv_refiner.values():
                r.out_conv.weight[:2] *= refiner_flow_gain
                r.out_conv.bias[:2] *= refiner_flow_gain
    net = net.to(device)
    if amp:
        set_precision(net, torch.bfloat16)
    return net.eval()


def matcher(net, coarse: int, up: int) -> RegressionMatcher:
    return RegressionMatcher(net, h=coarse, w=coarse, upsample_res=(up, up))


class _Captured(Exception):
    pass


@torch.inference_mode()
def capture_cls_logits(net, im_A, im_B) -> np.ndarray:
    """The symmetric coarse pass's scale-16 ``cls_logits`` with no bias for
    one pair of (1, H, W, 3) images, (2, gh, gw, cls_res^2) float32 NumPy;
    the pass stops right after them. They come before the bias hook, so one
    capture serves to solve the bias."""
    cap = {}

    def hook(module, args, out):
        cap["logits"] = out[0].float().cpu().numpy()
        raise _Captured

    dev, dt = next(net.parameters()).device, next(net.encoder.cnn.parameters()).dtype
    x = [torch.as_tensor(np.asarray(a, np.float32)).to(dev, dt) for a in (im_A, im_B)]
    handle = net.decoder.embedding_decoder.register_forward_hook(hook)
    try:
        net(*x, symmetric=True, scale_factor=math.sqrt(x[0].shape[1] * x[0].shape[2] / 560.0**2))
    except _Captured:
        pass
    finally:
        handle.remove()
    return cap["logits"]


def scene_tag(i: int) -> str:
    return f"scene{i}"


def scene_pairs(n_scenes: int, up: int) -> list[PosePair]:
    """The benchmark's pairs: geometry at the upsample resolution, where the
    keypoints live; ``im_A`` is the tag ``PrecomputedMatcher`` looks up."""
    out = []
    for i in range(n_scenes):
        s = make_scene(i, (up, up))
        out.append(PosePair(im_A=scene_tag(i), im_B=scene_tag(i) + "_B", K1=s.K1, K2=s.K2, R=s.R, t=s.t,
                            hw_A=(up, up), hw_B=(up, up)))
    return out


def scene_bias(net, i: int, coarse: int, up: int) -> np.ndarray:
    """Scene ``i``'s bias, solved against ``net``'s own cls_logits."""
    im_A, im_B, _, _ = scene_images(i, coarse, up)
    logits = capture_cls_logits(net, im_A, im_B)
    return render_gt_bias(make_scene(i, (up, up)), (coarse // 14, coarse // 14), cls_res=net.config.cls_res,
                          amp=BIAS_AMP, model_logits=logits)


def match_scene(m: RegressionMatcher, i: int, bias: np.ndarray):
    """Scene ``i`` through ``m.match`` with ``bias``: (warp, certainty) on
    the matcher's device."""
    coarse, up = m.h_resized, m.upsample_res[0]
    im_A, im_B, im_A_u, im_B_u = scene_images(i, coarse, up)
    return m.match(im_A[0], im_B[0], im_A_high_res=im_A_u[0], im_B_high_res=im_B_u[0], gm_logit_bias=bias)


def match_error_px(warp, i: int, up: int) -> np.ndarray:
    """The dense A -> B match error against the exact warp, in pixels at
    ``up``, on every 8th point of the A half where both lie in view (the
    JAX tool's transparency number)."""
    w = np.asarray(warp.float().cpu() if torch.is_tensor(warp) else warp, np.float64)
    q = w[::8, : w.shape[1] // 2 : 8]
    gt = gt_warp(make_scene(i, (up, up)), q[..., :2], "AtoB")
    ok = (np.abs(q[..., 2:]) < 0.999).all(-1) & (np.abs(gt) < 1).all(-1)
    return np.abs(q[..., 2:] - gt).max(-1)[ok] * up / 2


def error_percentiles(errs) -> dict:
    e = np.concatenate(errs)
    return {"p50": float(np.percentile(e, 50)), "p95": float(np.percentile(e, 95)), "max": float(e.max())}


class PrecomputedMatcher:
    """``match`` returns the stored (warp, certainty) of a pair's tag;
    ``sample`` and ``to_pixel_coordinates`` are the port's
    ``RegressionMatcher`` ones (``balanced_sample`` seeded by the
    benchmark's key on the warp's device)."""

    def __init__(self, results: dict):
        self.results = results

    def match(self, im_A, im_B):
        return self.results[im_A]

    def sample(self, matches, certainty, num=5000, key=None):
        if key is None:
            raise ValueError("PrecomputedMatcher samples with the benchmark's keys only")
        m = torch.as_tensor(matches).reshape(-1, 4)
        c = torch.as_tensor(certainty).reshape(-1)
        gen = torch.Generator(device=m.device).manual_seed(int(key))
        return balanced_sample(m, c, num, generator=gen, thresh=0.05, mode="threshold_balanced")

    to_pixel_coordinates = RegressionMatcher.to_pixel_coordinates
