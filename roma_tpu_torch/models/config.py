"""Size configuration for big RoMa.

The reference hard-codes every dimension inline in its model factory
(reference romatch/models/model_zoo/roma_models.py:71-181). Here the same
numbers live in ONE frozen dataclass so the architecture can be instantiated
at any size: the default ``RoMaConfig()`` is the released ViT-L model, and
``RoMaConfig.tiny()`` is a structurally identical miniature used by the
multi-chip dryrun and the fast test tier (every code path — GP, transformer
decoder, all five refiner scales, local correlation, BN — at dims that
compile in seconds on XLA:CPU).

All derived dimensions (projection inputs, refiner channel counts, decoder
token width) are computed from the base fields, mirroring how the reference's
literals relate to each other:
  * refiner in/hidden dim = 2*proj_out + disp_emb (+ (2r+1)^2 with local corr)
    (roma_models.py:90-139),
  * TransformerDecoder token dim = gp_dim + proj16_out (roma_models.py:75-84),
  * proj input dims follow the encoder channel plan (roma_models.py:156-169).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RefinerSpec:
    in_dim: int
    hidden_dim: int
    disp_emb_dim: int
    local_corr_radius: int | None = None
    kernel_size: int = 5
    hidden_blocks: int = 8


@dataclasses.dataclass(frozen=True)
class RoMaConfig:
    # VGG19-BN channel plan: channels of each conv, per pyramid stage
    # (stage boundary = MaxPool). Default = torchvision configuration "E".
    vgg_channels: tuple[tuple[int, ...], ...] = (
        (64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512)
    )
    # DINOv2 coarse encoder (default ViT-L/14, reference dinov2.py:333-345)
    dino_dim: int = 1024
    dino_depth: int = 24
    dino_heads: int = 16
    dino_patch: int = 14
    # serving-only: run the frozen DINOv2's proj, fc1 and fc2 in dynamic
    # int8 (ops/int8.py, the JAX package's formula; qkv stays float).
    # Changes numerics; validate golden metrics before enabling in production.
    vit_int8: bool = False
    # serving-only: the refiners' 1x1 convs in dynamic int8 on the wide
    # stacks (scales 16-2, C 144-1377); the scale-1 stack stays on Kernel D,
    # as the JAX package's fused path ignores it. Inference only, ignored in
    # train mode (round() has zero gradient); same validation caveat.
    refiner_int8: bool = False
    # serving-only: tanh-approximate GELU in the frozen DINOv2 MLPs instead
    # of the exact erf form of torch's nn.GELU default (reference
    # layers/mlp.py:21). The two differ by at most ~3e-4 absolute per
    # activation; same golden-metric caveat. roma_outdoor(amp=True) turns
    # it on, as the JAX package's default does.
    vit_gelu_tanh: bool = False
    # GP + transformer match proposer
    gp_dim: int = 512
    cls_res: int = 64          # coarse-match anchor grid (64x64 + 1 certainty)
    decoder_depth: int = 5
    decoder_heads: int = 8
    # per-scale heads: (scale, value) pairs — tuples, not dicts, so the config
    # stays hashable as a flax module field
    proj_out: tuple[tuple[int, int], ...] = (
        (16, 512), (8, 512), (4, 256), (2, 64), (1, 9)
    )
    disp_emb: tuple[tuple[int, int], ...] = (
        (16, 128), (8, 64), (4, 32), (2, 16), (1, 6)
    )
    # 0 = no local correlation at that scale
    corr_radius: tuple[tuple[int, int], ...] = (
        (16, 7), (8, 3), (4, 2), (2, 0), (1, 0)
    )
    hidden_blocks: int = 8

    # ------------------------------------------------------------------ #
    # derived
    # ------------------------------------------------------------------ #

    @property
    def feat_dim(self) -> int:
        """proj16 output width — the feature half of the decoder tokens."""
        return dict(self.proj_out)[16]

    @property
    def decoder_dim(self) -> int:
        return self.gp_dim + self.feat_dim

    def proj_specs(self) -> dict[int, tuple[int, int]]:
        """{scale: (in_channels, out_channels)} for the 1x1 projections."""
        st = self.vgg_channels
        ins = {16: self.dino_dim, 8: st[3][-1], 4: st[2][-1], 2: st[1][-1], 1: st[0][-1]}
        return {s: (ins[s], out) for s, out in self.proj_out}

    def refiner_specs(self) -> dict[int, RefinerSpec]:
        proj = dict(self.proj_out)
        emb = dict(self.disp_emb)
        rad = dict(self.corr_radius)
        specs = {}
        for s in proj:
            r = rad[s] or None
            d = 2 * proj[s] + emb[s] + ((2 * r + 1) ** 2 if r else 0)
            specs[s] = RefinerSpec(
                in_dim=d, hidden_dim=d, disp_emb_dim=emb[s],
                local_corr_radius=r, hidden_blocks=self.hidden_blocks,
            )
        return specs

    # ------------------------------------------------------------------ #
    # presets
    # ------------------------------------------------------------------ #

    @staticmethod
    def tiny() -> "RoMaConfig":
        """Structurally complete miniature: same stages, scales, and code
        paths as the released model at ~1/1000 the parameter count. Used by
        ``__graft_entry__.dryrun_multichip`` and the fast test tier."""
        return RoMaConfig(
            vgg_channels=((8, 8), (16, 16), (16, 16, 16, 16), (24, 24, 24, 24)),
            dino_dim=32,
            dino_depth=2,
            dino_heads=2,
            gp_dim=16,
            cls_res=16,
            decoder_depth=2,
            decoder_heads=2,
            proj_out=((16, 16), (8, 16), (4, 16), (2, 16), (1, 9)),
            disp_emb=((16, 8), (8, 8), (4, 8), (2, 8), (1, 6)),
            corr_radius=((16, 3), (8, 2), (4, 1), (2, 0), (1, 0)),
            hidden_blocks=2,
        )

    @staticmethod
    def small() -> "RoMaConfig":
        """``tiny()`` with head dims of 64 in DINOv2 and the
        TransformerDecoder, the narrowest configuration whose attention
        takes the port's Kernels A and E on the card (``tiny()``'s head dim
        of 16 goes to the einsum there); scale 16's local correlation at the
        released radius 7, scale 8's at 3, scale 4's at 2."""
        return RoMaConfig(
            vgg_channels=((8, 8), (16, 16), (16, 16, 16, 16), (24, 24, 24, 24)),
            dino_dim=128,
            dino_depth=2,
            dino_heads=2,
            gp_dim=64,
            cls_res=16,
            decoder_depth=2,
            decoder_heads=2,
            proj_out=((16, 64), (8, 16), (4, 16), (2, 16), (1, 9)),
            disp_emb=((16, 8), (8, 8), (4, 8), (2, 8), (1, 6)),
            corr_radius=((16, 7), (8, 3), (4, 2), (2, 0), (1, 0)),
            hidden_blocks=2,
        )
