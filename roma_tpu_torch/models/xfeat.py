"""XFeat backbone, the Tiny RoMa feature extractor (counterpart of
roma_tpu/models/xfeat.py).

The public XFeat encoder ("XFeat: Accelerated Features for Lightweight Image
Matching", CVPR 2024, hub ``verlab/accelerated_features``) as the reference
Tiny RoMa uses it (``romatch/models/tiny.py:81-99``): the grayscale mean,
instance norm, block1 .. block5 with a stride-4 skip, then the fusion of
block3 with block4 and block5 upsampled to its size. Module names are the hub
state dict's (``block1.0.layer.0.weight``, ``skip1.1``, ``block_fusion.2``);
its keypoint, heatmap and fine-matcher heads are never built (the reference
deletes them, tiny.py:42).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import interpolate
from .blocks import BasicLayer, instance_norm, nhwc

# (c_out, kernel, stride) of each BasicLayer; kernel 1 has no padding
_BLOCKS = {
    "block1": ((4, 3, 1), (8, 3, 2), (8, 3, 1), (24, 3, 2)),
    "block2": ((24, 3, 1), (24, 3, 1)),
    "block3": ((64, 3, 2), (64, 3, 1), (64, 1, 1)),
    "block4": ((64, 3, 2), (64, 3, 1), (64, 3, 1)),
    "block5": ((128, 3, 2), (128, 3, 1), (128, 3, 1), (64, 1, 1)),
}


def _layers(c_in: int, specs) -> list[BasicLayer]:
    out = []
    for c_out, k, s in specs:
        out.append(BasicLayer(c_in, c_out, k, stride=s, padding=k // 2))
        c_in = c_out
    return out


class XFeatBackbone(nn.Module):
    """(B, H, W, 3) images in [0, 1], H and W multiples of 32 -> NHWC
    (fine (B, H/4, W/4, 24), coarse (B, H/8, W/8, 64))."""

    def __init__(self):
        super().__init__()
        self.skip1 = nn.Sequential(nn.AvgPool2d(4, stride=4), nn.Conv2d(1, 24, 1))
        c_in = 1
        for name, specs in _BLOCKS.items():  # each block takes the previous one's output
            setattr(self, name, nn.Sequential(*_layers(c_in, specs)))
            c_in = specs[-1][0]
        self.block_fusion = nn.Sequential(*_layers(64, ((64, 3, 1), (64, 3, 1))), nn.Conv2d(64, 64, 1))

    def forward(self, x: torch.Tensor):
        x = instance_norm(x.mean(dim=-1, keepdim=True))
        x1 = self.block1(x)
        x2 = self.block2(x1 + nhwc(self.skip1, x))
        x3 = self.block3(x2)
        x4 = self.block4(x3)
        x5 = self.block5(x4)
        h3, w3 = x3.shape[1:3]
        # the reference's default bilinear upsampling, align_corners=False
        x4 = interpolate(x4, (h3, w3), mode="bilinear")
        x5 = interpolate(x5, (h3, w3), mode="bilinear")
        fused = self.block_fusion[1](self.block_fusion[0](x3 + x4 + x5))
        return x2, nhwc(self.block_fusion[2], fused)
