"""Big RoMa match heads and coarse-to-fine decoder (counterpart of
roma_tpu/models/matcher.py), NHWC at every public boundary.

  * ``GP``: cosine-kernel Gaussian-process regression onto a Fourier basis of
    B's coordinates, in float32, by Cholesky factor and two triangular solves.
  * ``TransformerDecoder``: pre-norm ViT blocks over cat(GP posterior,
    features), a linear head to cls_res^2 + 1 anchor logits and certainty.
  * ``ConvRefiner``: x_hat lookup (Kernel C), displacement embedding, local
    correlation (Kernel B), depthwise 5x5 blocks, float32 out_conv. In
    inference the blocks run folded: on Kernel D when the stack is at most
    32 wide, else as Kernel N and one GEMM a block on the stack's channels
    padded once to a multiple of 8 (:func:`~roma_tpu_torch.ops.wide_stack`).
    In training mode the kernels give way to their plain versions and the
    blocks run as modules, as the JAX package's ``inference=not
    self.train`` does: the kernels are forward-only. ``refiner_int8`` puts
    the blocks' 1x1 convs of the wider stacks (scales 16-2) on dynamic int8
    outside training (:class:`~.blocks.QConv1x1`), where the blocks run as
    modules; the scale-1 stack stays on Kernel D, as the JAX package's fused
    path ignores ``int8``.
  * ``Decoder``: the scale loop, 16 -> 1, or 8 -> 1 in the upsample pass; in
    training mode it also returns the anchor logits ``gm_cls``, their
    certainty ``gm_certainty``, ``flow_pre_delta`` and ``delta_flow``, which
    the losses read.

Under ``torch.autocast`` the GP (kernel matrices, Cholesky, triangular
solves) and every out_conv stay in float32, the JAX package's float32
islands.

``RoMaNet(remat=True)`` rematerializes the training forward at the JAX
package's sites (roma_tpu/models/matcher.py:194-200, 314-315, 338): the GP,
the TransformerDecoder, each ConvRefiner and each of its blocks run under
:func:`~.blocks.checkpointed`, which keeps the parameter names and moves each
BatchNorm's running statistics once a step. Kernel A's forward runs again
for the TransformerDecoder's blocks in the backward.

Spans (``utils.profiling``, each with its device time): in
``Decoder.forward``, ``roma.net.gm`` around the global match (GP,
TransformerDecoder, the logit bias, ``cls_to_flow_refine``) and
``roma.net.refine.s<scale>`` around each ConvRefiner call.

Module names follow the released checkpoint (``decoder.gps.16``,
``decoder.proj.{s}.{0,1}``, ``decoder.conv_refiner.{s}.block1``,
``hidden_blocks.{j}``, ``out_conv``, ``disp_emb``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops import (
    cls_to_flow_refine,
    fold_refiner,
    fused_refiner_stack,
    interpolate,
    local_correlation,
    local_correlation_reference,
    normalized_grid,
    warp_sample,
    warp_sample_reference,
)
from ..ops.depthwise import padded_block, padded_width, wide_stack
from ..ops.refiner_stack import MAX_C
from ..utils.profiling import annotate
from .blocks import QConv1x1, checkpointed, nhwc, refiner_block
from .config import RefinerSpec, RoMaConfig
from .encoders import CNNandDinov2
from .vit import Block


def cos_kernel(x: torch.Tensor, y: torch.Tensor, T: float, eps: float = 1e-6):
    """K = exp((cos(x, y) - 1) / T); x (B, N, D), y (B, M, D) float32."""
    c = x @ y.transpose(-1, -2)
    nx, ny = x.norm(dim=-1), y.norm(dim=-1)
    c = c / (nx[..., :, None] * ny[..., None, :] + eps)
    return torch.exp((c - 1.0) / T)


class GP(nn.Module):
    """GP regression from B-features to B's Fourier positional basis
    (reference matcher.py:203-323, eval path). Runs in float32."""

    T = 0.2  # cosine-kernel temperature
    SIGMA_NOISE = 0.1

    def __init__(self, gp_dim: int = 512):
        super().__init__()
        self.gp_dim = gp_dim
        self.pos_conv = nn.Conv2d(2, gp_dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return self._posterior(x, y)

    def _posterior(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, h1, w1, c = x.shape
        _, h2, w2, _ = y.shape
        m = h2 * w2
        coords = normalized_grid(h2, w2, device=x.device)[None]
        pos = nhwc(self.pos_conv, coords)
        f = torch.cos(8 * math.pi * pos).reshape(1, m, self.gp_dim).expand(b, m, self.gp_dim)
        xf = x.float().reshape(b, h1 * w1, c)
        yf = y.float().reshape(b, m, c)
        k_yy = cos_kernel(yf, yf, self.T)
        k_xy = cos_kernel(xf, yf, self.T)
        k_yy = k_yy + self.SIGMA_NOISE * torch.eye(m, device=x.device)
        chol = torch.linalg.cholesky_ex(k_yy).L  # no host sync on the info check
        z = torch.linalg.solve_triangular(chol, f, upper=False)
        w = torch.linalg.solve_triangular(chol.transpose(-1, -2), z, upper=True)
        return (k_xy @ w).reshape(b, h1, w1, self.gp_dim)


class TransformerDecoder(nn.Module):
    """ViT blocks + linear head to cls_res^2 + 1 channels
    (reference transformer/__init__.py:10-46)."""

    def __init__(self, depth: int, dim: int, num_heads: int, out_dim: int):
        super().__init__()
        # reference Block defaults: no qkv bias, no LayerScale
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, layer_scale=False, qkv_bias=False) for _ in range(depth)
        )
        self.to_out = nn.Linear(dim, out_dim)

    def forward(self, gp_posterior: torch.Tensor, features: torch.Tensor):
        b, h, w, _ = gp_posterior.shape
        dt = self.to_out.weight.dtype
        tokens = torch.cat((gp_posterior.to(dt), features.to(dt)), dim=-1).reshape(b, h * w, -1)
        for blk in self.blocks:
            tokens = blk(tokens)
        out = self.to_out(tokens).float().reshape(b, h, w, -1)
        return out[..., :-1], out[..., -1:]


class ConvRefiner(nn.Module):
    """Per-scale refinement CNN (reference matcher.py:23-179). ``int8``: the
    blocks' 1x1 convs in dynamic int8 outside training, on a stack wider
    than Kernel D's MAX_C (a narrower one runs folded on D in inference)."""

    def __init__(self, spec: RefinerSpec, remat: bool = False, int8: bool = False):
        super().__init__()
        self.spec = spec
        self.remat = remat
        k = spec.kernel_size
        int8 = int8 and spec.hidden_dim > MAX_C
        self.block1 = refiner_block(spec.in_dim, spec.hidden_dim, k, int8)
        self.hidden_blocks = nn.ModuleList(
            refiner_block(spec.hidden_dim, spec.hidden_dim, k, int8) for _ in range(spec.hidden_blocks)
        )
        self.out_conv = nn.Conv2d(spec.hidden_dim, 3, 1)
        self.disp_emb = nn.Conv2d(2, spec.disp_emb_dim, 1)
        self._folded = (None, None)  # (key, folded blocks) for Kernels D and N

    def folded_blocks(self, dtype: torch.dtype | None = None) -> list[dict]:
        """The blocks folded for Kernel D (fold_refiner) or, given the I/O
        ``dtype``, as Kernel N and the GEMM take them (padded_block of each
        fold; the fold is not kept, as its float32 C x C weights would
        outweigh the stack's own), folded again only when a source tensor or
        the dtype changed: the cache is keyed on each parameter's and running
        statistic's (data_ptr, _version, dtype), so copy_, load_state_dict, a
        training step and set_precision all refold. The fold runs outside
        inference mode, since match() runs under torch.inference_mode and an
        inference tensor could not be used later where autograd is on."""
        srcs = [t for seq in (self.block1, *self.hidden_blocks) for t in (*seq.parameters(), *seq.buffers())]
        key = (tuple((t.data_ptr(), t._version, t.dtype) for t in srcs), dtype)
        if self._folded[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                if dtype is None:
                    blocks = fold_refiner(self.block1, self.hidden_blocks)
                else:
                    cp = padded_width(self.spec.hidden_dim)
                    blocks = [padded_block(fold_refiner(seq, [])[0], cp, dtype)
                              for seq in (self.block1, *self.hidden_blocks)]
                self._folded = (key, blocks)
        return self._folded[1]

    def _on_wide_stack(self) -> bool:
        """Whether the blocks run as :func:`~roma_tpu_torch.ops.wide_stack`:
        in inference, on a stack wider than Kernel D's MAX_C whose 1x1 convs
        are float (an int8 stack keeps its modules)."""
        return (not self.training and self.spec.hidden_dim > MAX_C
                and not isinstance(self.block1[3], QConv1x1))

    def forward(self, x, y, flow, scale_factor: float = 1.0):
        """x, y: (B, H, W, C) projected A/B features; flow (B, H, W, 2)
        float32 A->B warp. Returns (delta_flow, delta_certainty), float32."""
        b, hs, ws, _ = x.shape
        s = self.spec
        dt = self.disp_emb.weight.dtype
        x_hat = warp_sample_reference(y, flow) if self.training else warp_sample(y, flow)
        disp = flow - normalized_grid(hs, ws, device=flow.device)
        emb = nhwc(self.disp_emb, (40.0 / 32.0 * scale_factor * disp).to(dt))
        parts = [x, x_hat, emb]
        if s.local_corr_radius is not None:
            if self.training:
                # recompute the per-tap gathers in the backward instead of
                # saving them, as the JAX package checkpoints its chunks
                # (local_corr.py:337-347). It holds no BatchNorm, so plain
                # checkpoint will do (blocks.checkpointed is for code that does).
                corr = checkpoint(local_correlation_reference, x, y, s.local_corr_radius, flow,
                                  use_reentrant=False)
            else:
                corr = local_correlation(x, y, s.local_corr_radius, flow)
            parts.append(corr.to(dt))
        wide = self._on_wide_stack()
        if wide and padded_width(s.hidden_dim) > s.hidden_dim:  # zero channels up to Kernel N's alignment
            parts.append(emb.new_zeros(()).expand(b, hs, ws, padded_width(s.hidden_dim) - s.hidden_dim))
        d = torch.cat(parts, dim=-1)
        if not self.training and s.hidden_dim <= MAX_C:
            d = fused_refiner_stack(d, self.folded_blocks())
        elif wide:
            d = wide_stack(d, self.folded_blocks(d.dtype))[..., :s.hidden_dim]
        elif self.remat and self.training:
            d = d.permute(0, 3, 1, 2)
            for blk in (self.block1, *self.hidden_blocks):
                d = checkpointed(blk, d)
            d = d.permute(0, 2, 3, 1)
        else:
            d = nhwc(self.block1, d)
            for blk in self.hidden_blocks:
                d = nhwc(blk, d)
        with torch.autocast(d.device.type, enabled=False):  # out_conv stays float32
            out = nhwc(self.out_conv, d.float())
        return out[..., :2], out[..., 2:]


class Decoder(nn.Module):
    """Scale loop (reference matcher.py:326-527); ``upsample=True`` runs
    scales 8..1 seeded with the previous pass's finest flow/certainty."""

    REFINE_INIT = 4  # delta-flow scale of the reference decoder

    def __init__(self, config: RoMaConfig = RoMaConfig(), remat: bool = False):
        super().__init__()
        self.remat = remat
        self.embedding_decoder = TransformerDecoder(
            config.decoder_depth, config.decoder_dim, config.decoder_heads, config.cls_res**2 + 1
        )
        self.gps = nn.ModuleDict({"16": GP(config.gp_dim)})
        self.proj = nn.ModuleDict({
            str(s): nn.Sequential(nn.Conv2d(cin, cout, 1), nn.BatchNorm2d(cout))
            for s, (cin, cout) in config.proj_specs().items()
        })
        self.conv_refiner = nn.ModuleDict({
            str(s): ConvRefiner(spec, remat, config.refiner_int8) for s, spec in config.refiner_specs().items()
        })

    def _call(self, module: nn.Module, *args, **kwargs):
        """``module(*args, **kwargs)``, under checkpoint in training with remat."""
        if self.remat and self.training:
            return checkpointed(module, *args, **kwargs)
        return module(*args, **kwargs)

    def forward(self, f1, f2, upsample=False, flow=None, certainty=None,
                scale_factor: float = 1.0, gm_logit_bias=None):
        """``gm_logit_bias`` (B, H16, W16, cls_res^2) is the diagnostic hook of
        roma_tpu/models/matcher.py:361-366: added to the coarse anchor logits
        before cls_to_flow_refine. Never set on the production path. Scale
        16's flow keeps its graph, so in training the refiner's bilinear
        fractions carry gradient back into the TransformerDecoder."""
        scales = [8, 4, 2, 1] if upsample else [16, 8, 4, 2, 1]
        sizes = {s: (f.shape[1], f.shape[2]) for s, f in f1.items()}
        h, w = sizes[1]
        b = f1[1].shape[0]
        dev = f1[1].device
        coarsest = scales[0]
        if not upsample:
            flow = normalized_grid(*sizes[coarsest], device=dev).expand(b, *sizes[coarsest], 2)
            certainty = torch.zeros((b, *sizes[coarsest], 1), device=dev)
        else:
            flow = interpolate(flow, sizes[coarsest], mode="bilinear")
            certainty = interpolate(certainty, sizes[coarsest], mode="bilinear")

        corresps: dict[int, dict[str, torch.Tensor]] = {}
        for ins in scales:
            corresps[ins] = out = {}
            proj = self.proj[str(ins)]
            dt = proj[0].weight.dtype
            # in training the projection BN moves its running stats twice a
            # step, on f1_s and then on f2_s, as the JAX package's does
            f1_s = nhwc(proj, f1[ins].to(dt)).contiguous()
            f2_s = nhwc(proj, f2[ins].to(dt)).contiguous()
            if ins == 16 and not upsample:
                with annotate("roma.net.gm", device=True):
                    gp_posterior = self._call(self.gps["16"], f1_s, f2_s)
                    cls_logits, certainty = self._call(self.embedding_decoder, gp_posterior, f1_s)
                    if gm_logit_bias is not None:
                        cls_logits = cls_logits + gm_logit_bias
                    flow = cls_to_flow_refine(cls_logits)
                if self.training:
                    out.update(gm_cls=cls_logits, gm_certainty=certainty)
            flow = flow.float().contiguous()
            if self.training:
                out["flow_pre_delta"] = flow
            with annotate(f"roma.net.refine.s{ins}", device=True):
                delta_flow, delta_certainty = self._call(
                    self.conv_refiner[str(ins)], f1_s, f2_s, flow, scale_factor=scale_factor
                )
            if self.training:
                out["delta_flow"] = delta_flow
            displacement = ins * torch.stack(
                (delta_flow[..., 0] / (self.REFINE_INIT * w),
                 delta_flow[..., 1] / (self.REFINE_INIT * h)),
                dim=-1,
            )
            flow = flow + displacement
            certainty = certainty + delta_certainty
            out.update(certainty=certainty, flow=flow)
            if ins != 1:
                flow = interpolate(flow, sizes[ins // 2], mode="bilinear").detach()
                certainty = interpolate(certainty, sizes[ins // 2], mode="bilinear").detach()
        return corresps


class RoMaNet(nn.Module):
    """Encoder + decoder with the reference's A|B concat batching
    (reference matcher.py:585-670). ``remat`` rematerializes the training
    forward (see the module's docstring); it changes no value and no
    parameter name."""

    def __init__(self, config: RoMaConfig = RoMaConfig(), remat: bool = False):
        super().__init__()
        self.config = config
        self.encoder = CNNandDinov2(config, remat)
        self.decoder = Decoder(config, remat)

    def set_remat(self, on: bool) -> "RoMaNet":
        """Switch remat at every site: each submodule that holds a ``remat``
        flag (the encoder, the decoder, each ConvRefiner)."""
        for m in self.modules():
            if hasattr(m, "remat"):
                m.remat = on
        return self

    def forward(self, im_A, im_B, symmetric: bool = False, upsample=False, flow=None,
                certainty=None, scale_factor: float = 1.0, gm_logit_bias=None):
        """A and B run through the encoder as one batch. ``symmetric``: the
        decoder's batch is [A->B, B->A], so flows and certainties come back
        with batch 2B (the matcher); otherwise A->B only (training)."""
        pyramid = self.encoder(torch.cat((im_A, im_B), dim=0), upsample=upsample)
        halves = {s: f.chunk(2) for s, f in pyramid.items()}
        if symmetric:
            f_q = pyramid
            f_s = {s: torch.cat(h[::-1], dim=0) for s, h in halves.items()}
        else:
            f_q = {s: h[0] for s, h in halves.items()}
            f_s = {s: h[1] for s, h in halves.items()}
        return self.decoder(f_q, f_s, upsample=upsample, flow=flow, certainty=certainty,
                            scale_factor=scale_factor, gm_logit_bias=gm_logit_bias)
