"""DINOv2 ViT blocks (counterpart of roma_tpu/models/vit.py), token layout
(B, N, D).

Module and parameter names follow the released DINOv2 checkpoint
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``ls1.gamma``, ...), so its
state dict loads as is. The JAX package's scan-stacked blocks are an
``nn.ModuleList`` here, and its lane padding of the token count is not
needed: Kernel A masks ragged tiles itself. ``int8`` (the ``vit_int8``
serving knob) runs proj, fc1 and fc2 through :class:`QLinear`; qkv stays
float, as the JAX package's does.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops import attention_packed_reference, fused_attention_packed, interpolate
from ..ops.attention import KERNEL_HEAD_DIMS
from ..ops.int8 import QuantizedWeight, int8_matmul_quantized


class QLinear(nn.Linear):
    """``nn.Linear`` computed through dynamic int8 when ``int8`` is set
    (ops/int8.py; the JAX package's QDense). Its parameters are
    nn.Linear's (weight (N, K), bias), so checkpoints and converters do not
    see which one built a model; they stay float32 under amp
    (zoo.set_precision), since the int8 weight is quantized from the float32
    one. The int8 weight is cached until the weight changes."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, int8: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.int8 = int8
        self._quantized = QuantizedWeight()

    def forward(self, x):
        if not self.int8:
            return super().forward(x)
        return int8_matmul_quantized(x, *self._quantized(self.weight), self.bias, out_dtype=x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu_tanh: bool = False, int8: bool = False):
        super().__init__()
        self.fc1 = QLinear(dim, hidden, int8=int8)
        # torch nn.GELU default is exact erf; tanh is the amp serving knob
        self.act = nn.GELU(approximate="tanh" if gelu_tanh else "none")
        self.fc2 = QLinear(hidden, dim, int8=int8)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, int8: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = QLinear(dim, dim, int8=int8)

    def forward(self, x):
        qkv = self.qkv(x)
        if qkv.is_cuda and qkv.shape[-1] // (3 * self.num_heads) not in KERNEL_HEAD_DIMS:
            # a head dim Kernel A does not take goes to the einsum on the
            # card, as the JAX package routes it (roma_tpu/ops/attention.py:92-96)
            return self.proj(attention_packed_reference(qkv, self.num_heads))
        return self.proj(fused_attention_packed(qkv, self.num_heads))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    """Pre-norm ViT block, eval path (reference layers/block.py)."""

    def __init__(self, dim: int, num_heads: int, layer_scale: bool, qkv_bias: bool = True,
                 gelu_tanh: bool = False, int8: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, int8=int8)
        self.ls1 = LayerScale(dim) if layer_scale else nn.Identity()
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, gelu_tanh=gelu_tanh, int8=int8)
        self.ls2 = LayerScale(dim) if layer_scale else nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoV2(nn.Module):
    """DINOv2 forward_features: normalized patch tokens as an NHWC map."""

    def __init__(self, embed_dim=1024, depth=24, num_heads=16, patch_size=14,
                 pretrain_img_size=518, gelu_tanh=False, int8=False):
        super().__init__()
        self.patch_size = patch_size
        n = (pretrain_img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, layer_scale=True, gelu_tanh=gelu_tanh, int8=int8)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3), H and W multiples of 14 -> (B, H/14, W/14, D)."""
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        tok = self.patch_embed.proj(x.permute(0, 3, 1, 2))  # (B, D, gh, gw)
        tok = tok.flatten(2).transpose(1, 2)
        tok = torch.cat((self.cls_token.expand(b, -1, -1).to(tok.dtype), tok), dim=1)
        tok = tok + self._pos_encoding(gh, gw).to(tok.dtype)
        for blk in self.blocks:
            tok = blk(tok)
        tok = self.norm(tok)
        return tok[:, 1:].reshape(b, gh, gw, -1)

    def _pos_encoding(self, gh: int, gw: int):
        """Bicubic resize of the pretraining pos-embed grid with torch's
        scale_factor + 0.1 trick (reference dinov2.py:166-190)."""
        pos = self.pos_embed
        n = pos.shape[1] - 1
        side = int(math.sqrt(n))
        if gh * gw == n and gh == gw:
            return pos
        patch = pos[:, 1:].reshape(1, side, side, -1)
        patch = interpolate(patch, (gh, gw), mode="bicubic",
                            scale_factor=((gh + 0.1) / side, (gw + 0.1) / side))
        return torch.cat((pos[:, :1], patch.reshape(1, gh * gw, -1)), dim=1)


def vit_large(device="cuda") -> DinoV2:
    """The DINOv2 ViT-L/14 preset (reference dinov2.py:333-345; the JAX
    package's ``vit_large``), made on ``device`` with torch's default
    initialization: load weights into it, or pass ``device="meta"`` for its
    layout alone."""
    with torch.device(device):
        return DinoV2(embed_dim=1024, depth=24, num_heads=16)
