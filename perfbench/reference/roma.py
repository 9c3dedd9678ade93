"""Plain float32 RoMa: the two-pass matcher and the training forward.

A frozen copy of what roma_tpu_torch computes, written with plain torch
operations over a dict of float32 tensors named as the released checkpoint
names them. Every hand-written kernel of the program is replaced here by the
plain operation it computes: attention by softmax(q k^T / sqrt(d)) v, the
local correlation by one gather a tap, the x_hat lookup by a four-tap
bilinear gather, the narrow refiner stack by its unfolded depthwise conv,
BatchNorm, ReLU and 1x1 conv. Nothing here imports the program. Callers set
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` (see :func:`strict_float32`).

Tensors at the public boundaries are NHWC, as the program's are.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch.utils.checkpoint import checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INIT_STD = 0.02


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at 448), back in float32; the gradient passes straight through."""
    s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


def strict_float32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------------
# the parameters: names, shapes and the seeded-init rule
# ----------------------------------------------------------------------------

def refiner_dims(cfg: dict) -> dict[int, tuple[int, int, int | None]]:
    """{scale: (width, displacement-embedding width, corr radius or None)}."""
    proj, emb, rad = (dict((int(s), v) for s, v in cfg[k]) for k in ("proj_out", "disp_emb", "corr_radius"))
    out = {}
    for s in proj:
        r = rad[s] or None
        out[s] = (2 * proj[s] + emb[s] + ((2 * r + 1) ** 2 if r else 0), emb[s], r)
    return out


def proj_dims(cfg: dict) -> dict[int, tuple[int, int]]:
    st = cfg["vgg_channels"]
    ins = {16: cfg["dino_dim"], 8: st[3][-1], 4: st[2][-1], 2: st[1][-1], 1: st[0][-1]}
    return {int(s): (ins[int(s)], out) for s, out in cfg["proj_out"]}


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """Every tensor of the model as (name, shape, kind); kind "randn" draws
    N(0, INIT_STD^2), "ones" and "zeros" are constants, "count" is a
    BatchNorm's step counter (int64 0). The rule is the program's seeded
    init: norm scales, LayerScale gammas and running variances 1; biases and
    running means 0; every other tensor random."""
    out: list[tuple[str, tuple[int, ...], str]] = []

    def conv(name, cout, cin, k, bias=True):
        out.append((f"{name}.weight", (cout, cin, k, k), "randn"))
        if bias:
            out.append((f"{name}.bias", (cout,), "zeros"))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
                    (f"{name}.running_mean", (c,), "zeros"), (f"{name}.running_var", (c,), "ones"),
                    (f"{name}.num_batches_tracked", (), "count")])

    def linear(name, cout, cin, bias=True):
        out.append((f"{name}.weight", (cout, cin), "randn"))
        if bias:
            out.append((f"{name}.bias", (cout,), "zeros"))

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros")])

    def block(name, dim, layer_scale, qkv_bias):
        norm(f"{name}.norm1", dim)
        linear(f"{name}.attn.qkv", 3 * dim, dim, qkv_bias)
        linear(f"{name}.attn.proj", dim, dim)
        if layer_scale:
            out.append((f"{name}.ls1.gamma", (dim,), "ones"))
        norm(f"{name}.norm2", dim)
        linear(f"{name}.mlp.fc1", 4 * dim, dim)
        linear(f"{name}.mlp.fc2", dim, 4 * dim)
        if layer_scale:
            out.append((f"{name}.ls2.gamma", (dim,), "ones"))

    i, cin = 0, 3
    for stage in cfg["vgg_channels"]:
        for ch in stage:
            conv(f"encoder.cnn.layers.{i}", ch, cin, 3)
            bn(f"encoder.cnn.layers.{i + 1}", ch)
            cin, i = ch, i + 3
        i += 1
    d, p = cfg["dino_dim"], cfg["dino_patch"]
    side = 518 // p
    out.append(("encoder.dinov2.cls_token", (1, 1, d), "randn"))
    out.append(("encoder.dinov2.pos_embed", (1, side * side + 1, d), "randn"))
    conv("encoder.dinov2.patch_embed.proj", d, 3, p)
    for j in range(cfg["dino_depth"]):
        block(f"encoder.dinov2.blocks.{j}", d, True, True)
    norm("encoder.dinov2.norm", d)
    feat = dict((int(s), v) for s, v in cfg["proj_out"])[16]
    dec = cfg["gp_dim"] + feat
    for j in range(cfg["decoder_depth"]):
        block(f"decoder.embedding_decoder.blocks.{j}", dec, False, False)
    linear("decoder.embedding_decoder.to_out", cfg["cls_res"] ** 2 + 1, dec)
    conv("decoder.gps.16.pos_conv", cfg["gp_dim"], 2, 1)
    for s, (ci, co) in proj_dims(cfg).items():
        conv(f"decoder.proj.{s}.0", co, ci, 1)
        bn(f"decoder.proj.{s}.1", co)
    for s, (c, e, _) in refiner_dims(cfg).items():
        name = f"decoder.conv_refiner.{s}"
        for blk in ["block1"] + [f"hidden_blocks.{j}" for j in range(cfg["hidden_blocks"])]:
            out.append((f"{name}.{blk}.0.weight", (c, 1, 5, 5), "randn"))
            out.append((f"{name}.{blk}.0.bias", (c,), "zeros"))
            bn(f"{name}.{blk}.1", c)
            conv(f"{name}.{blk}.3", c, c, 1)
        conv(f"{name}.out_conv", 3, c, 1)
        conv(f"{name}.disp_emb", e, 2, 1)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The seeded float32 weights: one N(0, 1) draw for every random tensor
    at once, from a generator on ``device``, scaled by INIT_STD and cut
    into views; the same (cfg, seed, device) gives the same tensors."""
    specs = param_specs(cfg)
    n = sum(math.prod(shape) for _, shape, kind in specs if kind == "randn")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device).mul_(INIT_STD)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "randn":
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape)
            at += k
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
    return out


# ----------------------------------------------------------------------------
# plain operations
# ----------------------------------------------------------------------------

def normalized_grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) pixel centres in [-1, 1], (x, y) order."""
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device=device)
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack((gx, gy), dim=-1)


def resize(x: torch.Tensor, size, mode: str = "bilinear") -> torch.Tensor:
    """NHWC resize with F.interpolate (align_corners=False, no antialias)."""
    if tuple(size) == tuple(x.shape[1:3]):
        return x
    kw = {} if mode.startswith("nearest") else {"align_corners": False}
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode=mode, **kw).permute(0, 2, 3, 1)


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Sample NHWC ``x`` at ``grid`` (B, Hq, Wq, 2) in [-1, 1]: zeros outside,
    source coordinate (g + 1) * n / 2 - 0.5, four taps summed in float32."""
    b, h, w, c = x.shape
    g = grid.float()
    ix = (g[..., 0] + 1) * w / 2 - 0.5
    iy = (g[..., 1] + 1) * h / 2 - 0.5
    flat = x.reshape(b * h * w, c)
    base = torch.arange(b, device=x.device).view(b, *([1] * (grid.ndim - 2))) * (h * w)
    if mode == "nearest":
        xi, yi = torch.round(ix).long(), torch.round(iy).long()
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        return flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)] * valid.to(x.dtype)
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    fx, fy = (ix - x0f)[..., None], (iy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0 + dy, x0 + dx
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        out = out + flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)].float() * (wgt * valid)
    return out


def local_correlation(f0, f1, radius: int, warp):
    """(B, H, W, (2r+1)^2): f0[q] / sqrt(C) dotted with f1 bilinearly sampled
    at the (2r+1)^2 points one feature pixel apart around warp(q), dy-major,
    zeros outside; the integer taps gathered one at a time, then folded."""
    b, h, w, c = f0.shape
    wf = warp.float()
    ix = (wf[..., 0] + 1) * w / 2 - 0.5
    iy = (wf[..., 1] + 1) * h / 2 - 0.5
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    fy, fx = (iy - y0f)[..., None, None], (ix - x0f)[..., None, None]
    x0, y0 = x0f.long(), y0f.long()
    p = 2 * radius + 2
    f0s = f0.float() / math.sqrt(c)
    f1_flat = f1.reshape(b * h * w, c)
    bidx = torch.arange(b, device=f0.device).view(b, 1, 1) * (h * w)
    dots = []
    for u in range(p):
        for v in range(p):
            yy, xx = y0 + (u - radius), x0 + (v - radius)
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            tap = f1_flat[bidx + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)].float()
            dots.append((tap * f0s).sum(-1) * valid)
    dp = torch.stack(dots, dim=-1).reshape(b, h, w, p, p)
    out = ((1 - fy) * (1 - fx) * dp[..., :-1, :-1] + (1 - fy) * fx * dp[..., :-1, 1:]
           + fy * (1 - fx) * dp[..., 1:, :-1] + fy * fx * dp[..., 1:, 1:])
    return out.reshape(b, h, w, (p - 1) ** 2)


def cls_to_flow_refine(cls_logits: torch.Tensor) -> torch.Tensor:
    """Anchor logits (B, H, W, res^2) -> flow: the probability-weighted mean
    of the argmax anchor and its four neighbours (flat index +-1, +-res,
    clamped)."""
    c = cls_logits.shape[-1]
    res = round(math.sqrt(c))
    anchors = normalized_grid(res, res, cls_logits.device).reshape(c, 2)
    probs = torch.softmax(cls_logits.float(), dim=-1)
    mode = torch.argmax(probs, dim=-1)
    index = torch.stack((mode - 1, mode, mode + 1, mode - res, mode + res), dim=-1).clamp(0, c - 1)
    neigh_p = torch.gather(probs, -1, index)
    return (neigh_p[..., None] * anchors[index]).sum(-2) / neigh_p.sum(-1, keepdim=True)


# ----------------------------------------------------------------------------
# the network
# ----------------------------------------------------------------------------

class RoMaReference:
    """RoMaNet over the tensors of ``weights`` (by name, float32). ``train``
    normalizes every BatchNorm with its batch's statistics (the running
    statistics are not moved: no output of a training step reads them),
    returns the losses' extra outputs and keeps the graph; otherwise the
    running statistics normalize. ``gelu_tanh`` is the DINOv2 MLPs'
    tanh-approximate GELU (the configuration's amp setting). Where a graph
    is recorded, each VGG layer, local correlation, refiner block and
    decoder block is recomputed in the backward instead of kept
    (``torch.utils.checkpoint``): the same values in a fraction of the
    memory, so a training batch of 8 at 560^2 fits (``recompute``, on by
    default in training)."""

    BN_EPS = 1e-5
    GP_T, GP_NOISE = 0.2, 0.1
    REFINE_INIT = 4

    def __init__(self, cfg: dict, weights: dict[str, torch.Tensor], train: bool = False, fp8: bool = False,
                 recompute: bool | None = None):
        self.cfg, self.w, self.train = cfg, weights, train
        self.recompute = train if recompute is None else recompute
        # ``fp8``: every product's operands rounded to float8 (the control)
        self.q = fake_fp8 if fp8 else (lambda t: t)
        self.gelu_tanh = bool(cfg.get("vit_gelu_tanh", False))
        self.refiners = refiner_dims(cfg)

    def _ckpt(self, fn, *args):
        if self.recompute and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- pieces ------------------------------------------------------------
    def conv(self, x, name, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(self.w[f"{name}.weight"]), self.w.get(f"{name}.bias"), stride, padding, 1,
                        groups)

    def bn(self, x, name):
        w = self.w
        if self.train:
            return F.batch_norm(x, None, None, w[f"{name}.weight"], w[f"{name}.bias"], True, 0.0, self.BN_EPS)
        return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"], w[f"{name}.weight"],
                            w[f"{name}.bias"], False, 0.0, self.BN_EPS)

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w[f"{name}.weight"]), self.w.get(f"{name}.bias"))

    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"], 1e-6)

    def block(self, x, name, heads, layer_scale, gelu_tanh, keep=None):
        b, n, c = x.shape
        qkv = self.linear(self.layer_norm(x, f"{name}.norm1"), f"{name}.attn.qkv")
        q, k, v = qkv.view(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4).unbind(0)
        att = torch.softmax(self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(c // heads), dim=-1)
        att = self.q(att) @ self.q(v)
        y = self.linear(att.transpose(1, 2).reshape(b, n, c), f"{name}.attn.proj")
        x = x + (y * self.w[f"{name}.ls1.gamma"] if layer_scale else y)
        h = self.linear(self.layer_norm(x, f"{name}.norm2"), f"{name}.mlp.fc1")
        h = self.linear(F.gelu(h, approximate="tanh" if gelu_tanh else "none"), f"{name}.mlp.fc2")
        if keep is not None:
            keep["mlp"] = h
        return x + (h * self.w[f"{name}.ls2.gamma"] if layer_scale else h)

    # -- encoders ----------------------------------------------------------
    def vgg(self, x_nhwc):
        feats, y, i, scale = {}, x_nhwc.permute(0, 3, 1, 2), 0, 1
        for stage in self.cfg["vgg_channels"]:
            for _ in stage:
                y = self._ckpt(lambda t, i=i: F.relu(self.bn(self.conv(t, f"encoder.cnn.layers.{i}", padding=1),
                                                             f"encoder.cnn.layers.{i + 1}")), y)
                i += 3
            feats[scale] = y.permute(0, 2, 3, 1)
            if scale == 8:
                break
            y = F.max_pool2d(y, 2, 2)
            scale, i = scale * 2, i + 1
        return feats

    def dinov2(self, x_nhwc, keep=None):
        p = self.cfg["dino_patch"]
        b, h, w, _ = x_nhwc.shape
        gh, gw = h // p, w // p
        tok = self.conv(x_nhwc.permute(0, 3, 1, 2), "encoder.dinov2.patch_embed.proj", stride=p)
        tok = tok.flatten(2).transpose(1, 2)
        tok = torch.cat((self.w["encoder.dinov2.cls_token"].expand(b, -1, -1), tok), dim=1)
        pos = self.w["encoder.dinov2.pos_embed"]
        side = int(math.sqrt(pos.shape[1] - 1))
        if not (gh * gw == side * side and gh == gw):
            grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
            grid = F.interpolate(grid, scale_factor=((gh + 0.1) / side, (gw + 0.1) / side), mode="bicubic",
                                 align_corners=False)
            assert grid.shape[2:] == (gh, gw)
            pos = torch.cat((pos[:, :1], grid.flatten(2).transpose(1, 2)), dim=1)
        tok = tok + pos
        for j in range(self.cfg["dino_depth"]):
            first = {} if j == 0 and keep is not None else None
            tok = self.block(tok, f"encoder.dinov2.blocks.{j}", self.cfg["dino_heads"], True, self.gelu_tanh, first)
            if first is not None:
                keep.update(dinov2_block0=tok, dinov2_mlp0=first["mlp"])
        tok = self.layer_norm(tok, "encoder.dinov2.norm")
        return tok[:, 1:].reshape(b, gh, gw, -1)

    # -- decoder -----------------------------------------------------------
    def gp(self, x, y):
        b, h1, w1, c = x.shape
        _, h2, w2, _ = y.shape
        m = h2 * w2
        coords = normalized_grid(h2, w2, x.device)[None].permute(0, 3, 1, 2)
        pos = self.conv(coords, "decoder.gps.16.pos_conv").permute(0, 2, 3, 1)
        gp_dim = pos.shape[-1]
        f = torch.cos(8 * math.pi * pos).reshape(1, m, gp_dim).expand(b, m, gp_dim)

        def kern(a, bb):
            cs = a @ bb.transpose(-1, -2)
            cs = cs / (a.norm(dim=-1)[..., :, None] * bb.norm(dim=-1)[..., None, :] + 1e-6)
            return torch.exp((cs - 1.0) / self.GP_T)

        xf, yf = x.reshape(b, h1 * w1, c), y.reshape(b, m, c)
        k_yy = kern(yf, yf) + self.GP_NOISE * torch.eye(m, device=x.device)
        chol = torch.linalg.cholesky(k_yy)
        z = torch.linalg.solve_triangular(chol, f, upper=False)
        wts = torch.linalg.solve_triangular(chol.transpose(-1, -2), z, upper=True)
        return (kern(xf, yf) @ wts).reshape(b, h1, w1, gp_dim)

    def embedding_decoder(self, gp_posterior, feats):
        b, h, w, _ = gp_posterior.shape
        tok = torch.cat((gp_posterior, feats), dim=-1).reshape(b, h * w, -1)
        for j in range(self.cfg["decoder_depth"]):
            tok = self._ckpt(lambda t, j=j: self.block(t, f"decoder.embedding_decoder.blocks.{j}",
                                                       self.cfg["decoder_heads"], False, False), tok)
        out = self.linear(tok, "decoder.embedding_decoder.to_out").reshape(b, h, w, -1)
        return out[..., :-1], out[..., -1:]

    def refiner(self, s, x, y, flow, scale_factor):
        name = f"decoder.conv_refiner.{s}"
        b, hs, ws, _ = x.shape
        _, _, r = self.refiners[s]
        x_hat = grid_sample(y, flow)
        disp = flow - normalized_grid(hs, ws, flow.device)
        emb = self.conv((40.0 / 32.0 * scale_factor * disp).permute(0, 3, 1, 2), f"{name}.disp_emb")
        parts = [x, x_hat, emb.permute(0, 2, 3, 1)]
        if r is not None:
            parts.append(self._ckpt(lambda a, b, f: local_correlation(a, b, r, f), x, y, flow))
        d = torch.cat(parts, dim=-1).permute(0, 3, 1, 2)
        c = d.shape[1]
        for blk in ["block1"] + [f"hidden_blocks.{j}" for j in range(self.cfg["hidden_blocks"])]:
            d = self._ckpt(lambda t, blk=blk: self.conv(F.relu(self.bn(self.conv(t, f"{name}.{blk}.0", padding=2,
                                                                                  groups=c), f"{name}.{blk}.1")),
                                                        f"{name}.{blk}.3"), d)
        out = self.conv(d, f"{name}.out_conv").permute(0, 2, 3, 1)
        return out[..., :2], out[..., 2:]

    def decoder(self, f1, f2, upsample=False, flow=None, certainty=None, scale_factor=1.0, gm_logit_bias=None):
        scales = [8, 4, 2, 1] if upsample else [16, 8, 4, 2, 1]
        sizes = {s: (f.shape[1], f.shape[2]) for s, f in f1.items()}
        h, w = sizes[1]
        b = f1[1].shape[0]
        dev = f1[1].device
        if not upsample:
            flow = normalized_grid(*sizes[16], dev).expand(b, *sizes[16], 2)
            certainty = torch.zeros((b, *sizes[16], 1), device=dev)
        else:
            flow = resize(flow, sizes[8])
            certainty = resize(certainty, sizes[8])
        corresps = {}
        for s in scales:
            corresps[s] = out = {}
            proj = lambda f: self.bn(self.conv(f.permute(0, 3, 1, 2), f"decoder.proj.{s}.0"),
                                     f"decoder.proj.{s}.1").permute(0, 2, 3, 1)
            f1_s, f2_s = proj(f1[s]), proj(f2[s])
            if s == 16 and not upsample:
                cls_logits, certainty = self.embedding_decoder(self.gp(f1_s, f2_s), f1_s)
                if gm_logit_bias is not None:
                    cls_logits = cls_logits + gm_logit_bias
                flow = cls_to_flow_refine(cls_logits)
                if self.train:
                    out.update(gm_cls=cls_logits, gm_certainty=certainty)
            if self.train:
                out["flow_pre_delta"] = flow
            delta_flow, delta_cert = self.refiner(s, f1_s, f2_s, flow, scale_factor)
            if self.train:
                out["delta_flow"] = delta_flow
            flow = flow + s * torch.stack((delta_flow[..., 0] / (self.REFINE_INIT * w),
                                           delta_flow[..., 1] / (self.REFINE_INIT * h)), dim=-1)
            certainty = certainty + delta_cert
            out.update(certainty=certainty, flow=flow)
            if s != 1:
                flow = resize(flow, sizes[s // 2]).detach()
                certainty = resize(certainty, sizes[s // 2]).detach()
        return corresps

    def forward(self, im_A, im_B, symmetric=False, upsample=False, flow=None, certainty=None,
                scale_factor=1.0, keep=None, gm_logit_bias=None):
        """The program's RoMaNet.forward. ``keep`` (a dict), when given,
        receives the coarse pass's DINOv2 tokens under "dinov2", its first
        block's output (class token first) under "dinov2_block0" and that
        block's MLP output under "dinov2_mlp0". ``gm_logit_bias`` is added to
        the coarse anchor logits, as the program's hook of that name does."""
        x = torch.cat((im_A, im_B), dim=0)
        pyramid = self.vgg(x)
        if not upsample:
            with torch.no_grad():
                pyramid[16] = self.dinov2(x, keep)
            if keep is not None:
                keep["dinov2"] = pyramid[16]
        halves = {s: f.chunk(2) for s, f in pyramid.items()}
        if symmetric:
            f_q, f_s = pyramid, {s: torch.cat(hh[::-1], dim=0) for s, hh in halves.items()}
        else:
            f_q, f_s = ({s: hh[0] for s, hh in halves.items()}, {s: hh[1] for s, hh in halves.items()})
        return self.decoder(f_q, f_s, upsample, flow, certainty, scale_factor, gm_logit_bias)


# ----------------------------------------------------------------------------
# the matcher
# ----------------------------------------------------------------------------

def prepare(pil: Image.Image, hw, device) -> torch.Tensor:
    """Bicubic resize on the host (PIL), [0, 1], ImageNet-normalized:
    (1, h, w, 3) float32."""
    x = torch.from_numpy(np.array(pil.convert("RGB").resize((hw[1], hw[0]), Image.BICUBIC))).to(device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return ((x.float() / 255.0 - mean) / std)[None]


def prepare_uint8(arr: torch.Tensor) -> torch.Tensor:
    """An (..., h, w, 3) uint8 tensor, already at size -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=arr.device)
    std = torch.tensor(IMAGENET_STD, device=arr.device)
    return (arr.float() / 255.0 - mean) / std


@torch.no_grad()
def match(net: RoMaReference, im_A, im_B, im_A_up, im_B_up, coarse_hw, up_hw, keep=None, gm_logit_bias=None):
    """The program's symmetric two-pass ``RegressionMatcher.match`` with
    certainty attenuation, on inputs already normalized: (warp (B, H, 2W, 4),
    certainty (B, H, 2W))."""
    sf = math.sqrt(coarse_hw[0] * coarse_hw[1] / 560.0 ** 2)
    c = net.forward(im_A, im_B, symmetric=True, scale_factor=sf, keep=keep, gm_logit_bias=gm_logit_bias)
    low = resize(c[16]["certainty"], up_hw)
    low = 0.5 * low * (low < 0)
    sf = math.sqrt(up_hw[0] * up_hw[1] / 560.0 ** 2)
    c = net.forward(im_A_up, im_B_up, symmetric=True, upsample=True, flow=c[1]["flow"],
                    certainty=c[1]["certainty"], scale_factor=sf)
    flow, cert = c[1]["flow"], c[1]["certainty"]
    b2, hs, ws, _ = flow.shape
    cert = torch.sigmoid((cert - low)[..., 0])
    cert = torch.where((flow.abs() > 1).any(dim=-1), torch.zeros_like(cert), cert)
    flow = flow.clamp(-1, 1)
    grid = normalized_grid(hs, ws, flow.device).expand(b2 // 2, hs, ws, 2)
    a2b, b2a = flow.chunk(2)
    warp = torch.cat((torch.cat((grid, a2b), dim=-1), torch.cat((b2a, grid), dim=-1)), dim=2)
    return warp, torch.cat(cert.chunk(2), dim=2)
