"""Model constructors (counterpart of roma_tpu/models/zoo/__init__.py).

``roma_outdoor`` builds the big-RoMa matcher at the released widths on
seeded random weights, as the JAX package does offline: loading the released
checkpoint waits until the weights are available. Parameters are made on the
meta device and filled in place on ``device``, so no second copy is ever
made. ``device`` defaults to ``"cuda"`` in every constructor here: a caller
who wants the CPU passes ``device="cpu"``, and on a machine without a card
the default raises instead of building on the CPU. ``amp=True`` runs in
bfloat16 with the JAX package's float32 islands:
the GP (kernel matrices, Cholesky, triangular solves) and every refiner's
out_conv.

``train_net`` builds the network for training
(experiments/train_roma_outdoor.py:64-71): float32 master parameters, bf16
compute only through ``torch.autocast`` (train/train.py). ``set_precision``
casts the parameters themselves, which suits serving and not AdamW.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from .config import RoMaConfig
from .matcher import RoMaNet
from .roma import RegressionMatcher
from .vit import LayerScale

INIT_STD = 0.02  # roma_tpu/utils/fast_init.py: kernels and embeddings ~ N(0, 0.02^2)


@torch.no_grad()
def init_random(net: nn.Module, seed: int, std: float = INIT_STD) -> nn.Module:
    """Seeded random init with the rule of roma_tpu/utils/fast_init.py: norm
    scales, LayerScale gammas and running variances 1; biases and running
    means 0; every other tensor N(0, std^2)."""
    device = next(net.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for mod in net.modules():
        norm = isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d, LayerScale))
        for name, t in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            if name in ("bias", "running_mean", "num_batches_tracked"):
                t.zero_()
            elif name == "running_var" or (norm and name in ("weight", "gamma")):
                t.fill_(1.0)
            else:
                t.copy_(std * torch.randn(t.shape, generator=gen, device=device))
    return net


def set_precision(net: RoMaNet, dtype: torch.dtype) -> RoMaNet:
    """Cast to the compute dtype, keeping the float32 islands."""
    net.to(dtype)
    net.decoder.gps.float()
    for refiner in net.decoder.conv_refiner.values():
        refiner.out_conv.float()
    return net


def build_net(config: RoMaConfig, device="cuda") -> RoMaNet:
    """Unfilled RoMaNet on ``device`` (allocated, not initialized)."""
    with torch.device("meta"):
        net = RoMaNet(config)
    return net.to_empty(device=device)


def train_net(config: RoMaConfig | None = None, device="cuda", seed: int = 0) -> RoMaNet:
    """RoMaNet in training mode on seeded random weights: float32
    parameters, DINOv2 frozen (no grad, so no optimizer state or decay),
    BatchNorms updating their running stats."""
    return init_random(build_net(config or RoMaConfig(), device), seed).train()


def roma_outdoor(
    device="cuda",
    seed: int = 0,
    amp: bool = True,
    coarse_res: int | tuple[int, int] = 560,
    upsample_res: int | tuple[int, int] = 864,
    config: RoMaConfig | None = None,
) -> RegressionMatcher:
    """RoMa outdoor (reference model_zoo/__init__.py:31-61) on seeded random
    weights. Under ``amp`` the DINOv2 MLPs use the tanh GELU, as the JAX
    package's ``vit_gelu_tanh`` default does; otherwise exact erf."""
    if isinstance(coarse_res, int):
        coarse_res = (coarse_res, coarse_res)
    if isinstance(upsample_res, int):
        upsample_res = (upsample_res, upsample_res)
    config = config or RoMaConfig()
    config = dataclasses.replace(config, vit_gelu_tanh=amp or config.vit_gelu_tanh)
    net = init_random(build_net(config, device), seed)
    set_precision(net, torch.bfloat16 if amp else torch.float32)
    return RegressionMatcher(
        net, h=coarse_res[0], w=coarse_res[1], upsample_res=upsample_res, seed=seed
    )
