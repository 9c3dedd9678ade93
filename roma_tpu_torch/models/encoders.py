"""Feature encoders (counterpart of roma_tpu/models/encoders.py): the
VGG19-BN fine pyramid and the frozen DINOv2 coarse tokens.

``VGG19.layers`` is torchvision's ``vgg19_bn().features[:40]`` index for
index (conv, BN, ReLU, ..., MaxPool), so the released checkpoint's
``encoder.cnn.layers.{i}`` keys load as they are.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..utils.profiling import annotate
from .blocks import checkpointed
from .config import RoMaConfig
from .vit import DinoV2


def vgg19_conv_indices(channels=RoMaConfig().vgg_channels) -> list[int]:
    """The index in ``VGG19.layers`` (torchvision's ``vgg19_bn().features``
    index) of each conv: a conv, its BatchNorm at index + 1 and a ReLU per
    conv, a MaxPool after each stage."""
    out, i = [], 0
    for stage in channels:
        for _ in stage:
            out.append(i)
            i += 3
        i += 1
    return out


class VGG19(nn.Module):
    """Pyramid {1: stage-1, 2: stage-2, 4: stage-3, 8: stage-4} NHWC maps,
    each taken before a MaxPool (reference encoders.py:6-27)."""

    def __init__(self, channels=RoMaConfig().vgg_channels):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 3
        for stage in channels:
            for ch in stage:
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.BatchNorm2d(ch), nn.ReLU()]
                cin = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        feats = {}
        y = x.permute(0, 3, 1, 2)
        scale = 1
        for layer in self.layers:
            if isinstance(layer, nn.MaxPool2d):
                feats[scale] = y.permute(0, 2, 3, 1)
                scale *= 2
                if scale > 8:  # the last pool's output is unused
                    break
            y = layer(y)
        return feats


class CNNandDinov2(nn.Module):
    """VGG pyramid + frozen DINOv2 tokens under key 16 (actual stride 14);
    DINOv2 is skipped in the upsample pass (reference encoders.py:29-68).

    DINOv2 is frozen as the JAX package's ``stop_gradient`` freezes it
    (roma_tpu/models/encoders.py:102): its parameters do not require grad
    and it runs under ``torch.no_grad``, so no graph is recorded and its
    attention takes Kernel A's forward-only launch. The VGG BatchNorms
    follow the module's train/eval mode. ``remat``: in training the VGG
    pyramid runs under :func:`checkpointed` (roma_tpu/models/encoders.py:86);
    DINOv2 records no graph, so it has nothing to recompute.

    Spans (``utils.profiling``, each with its device time): ``roma.net.vgg``
    around the pyramid and ``roma.net.dinov2`` around DINOv2."""

    def __init__(self, config: RoMaConfig = RoMaConfig(), remat: bool = False):
        super().__init__()
        self.remat = remat
        self.cnn = VGG19(config.vgg_channels)
        self.dinov2 = DinoV2(
            embed_dim=config.dino_dim, depth=config.dino_depth, num_heads=config.dino_heads,
            patch_size=config.dino_patch, gelu_tanh=config.vit_gelu_tanh, int8=config.vit_int8,
        ).requires_grad_(False)

    def forward(self, x: torch.Tensor, upsample: bool = False) -> dict[int, torch.Tensor]:
        with annotate("roma.net.vgg", device=True):
            pyramid = checkpointed(self.cnn, x) if self.remat and self.training else self.cnn(x)
        if not upsample:
            # in DINOv2's own dtype (RegressionMatcher's coarse_dtype)
            with torch.no_grad(), annotate("roma.net.dinov2", device=True):
                pyramid[16] = self.dinov2(x.to(self.dinov2.cls_token.dtype))
        return pyramid
