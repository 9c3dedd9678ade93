"""Model constructors (counterpart of roma_tpu/models/zoo/__init__.py):
``tiny_roma_v1_outdoor`` (reference model_zoo/__init__.py:18-28),
``roma_outdoor`` and ``roma_indoor`` (reference model_zoo/__init__.py:31-94),
``train_net`` and ``pretrained_backbone`` for training.

Weights are the released torch ``.pth`` checkpoints, a path or a state dict
each (``convert.py`` maps them onto the port's modules). As the reference
(``torch.hub.load_state_dict_from_url``) and the JAX package do, a
constructor at the released architecture downloads and caches them when
none are passed (``download.py``; ``ROMA_TPU_CACHE``, default
``~/.cache/roma_tpu``, the JAX package's cache); ``ROMA_TPU_OFFLINE=1``
skips every download. Without weights the matcher comes up on seeded random
weights: the right shapes and kernels, not pretrained accuracy.

Parameters are made on the meta device and filled in place on ``device``,
so no second copy is ever made. ``device`` defaults to ``"cuda"`` in every
constructor here: a caller who wants the CPU passes ``device="cpu"``, and
on a machine without a card the default raises instead of building on the
CPU. ``amp=True`` runs in bfloat16 with the JAX package's float32 islands:
the GP (kernel matrices, Cholesky, triangular solves) and every refiner's
out_conv; and the weights of the int8 layers (``vit_int8``,
``refiner_int8``), which are quantized from their float32 values, as the
JAX package quantizes from its float32 parameters.

``train_net`` builds the network for training
(experiments/train_roma_outdoor.py:64-71): float32 master parameters, bf16
compute only through ``torch.autocast`` (train/train.py). ``set_precision``
casts the parameters themselves, which suits serving and not AdamW.
"""
from __future__ import annotations

import dataclasses
import sys

import torch
import torch.nn as nn

from ..config import RoMaConfig
from ..matcher import RoMaNet
from ..roma import RegressionMatcher
from ..blocks import QConv1x1
from ..tiny import TinyRoMa, TinyRoMaNet
from ..vit import LayerScale, QLinear
from . import convert, download

# the architecture of the released checkpoints: only there does a
# constructor fetch weights
RELEASED = RoMaConfig()
WEIGHT_URLS = {
    "romatch": {
        "outdoor": "https://github.com/Parskatt/storage/releases/download/roma/roma_outdoor.pth",
        "indoor": "https://github.com/Parskatt/storage/releases/download/roma/roma_indoor.pth",
    },
    "tiny_roma_v1": {
        "outdoor": "https://github.com/Parskatt/storage/releases/download/roma/tiny_roma_v1_outdoor.pth",
    },
    "dinov2": "https://dl.fbaipublicfiles.com/dinov2/dinov2_vitl14/dinov2_vitl14_pretrain.pth",
    # torch.hub.load('verlab/accelerated_features', 'XFeat') resolves to:
    "xfeat": "https://github.com/verlab/accelerated_features/raw/main/weights/xfeat.pt",
    # torchvision vgg19_bn(pretrained=True), which the reference trains from
    # (encoders.py:9)
    "vgg19_bn": "https://download.pytorch.org/models/vgg19_bn-c79401a0.pth",
}


def _load_torch_state_dict(path) -> dict:
    return convert.state_dict_to_numpy(torch.load(path, map_location="cpu", weights_only=True))


def _fetch_state_dict(url) -> dict | None:
    """Download and cache ``url``; None when the environment is offline."""
    path = download.fetch(url)
    return None if path is None else _load_torch_state_dict(path)


def _state_dict(weights) -> dict:
    """A checkpoint given as a path or as a state dict -> numpy state dict."""
    return convert.state_dict_to_numpy(weights) if isinstance(weights, dict) else _load_torch_state_dict(weights)


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
    """Cast to the compute dtype, keeping the float32 islands and the int8
    layers' float32 weights."""
    net.to(dtype)
    net.decoder.gps.float()
    for refiner in net.decoder.conv_refiner.values():
        refiner.out_conv.float()
    for m in net.modules():
        if isinstance(m, QConv1x1) or (isinstance(m, QLinear) and m.int8):
            m.float()
    return net


def serving_knobs_off(config: RoMaConfig) -> RoMaConfig:
    """The architecture under the serving knobs (the JAX package's ``arch``):
    int8 and the GELU change no parameter, so released weights apply."""
    return dataclasses.replace(config, vit_int8=False, refiner_int8=False, vit_gelu_tanh=False)


def build_net(config: RoMaConfig, device="cuda", remat: bool = False) -> RoMaNet:
    """Unfilled RoMaNet on ``device`` (allocated, not initialized)."""
    with torch.device("meta"):
        net = RoMaNet(config, remat=remat)
    return net.to_empty(device=device)


def train_net(config: RoMaConfig | None = None, device="cuda", seed: int = 0, remat: bool = False) -> RoMaNet:
    """RoMaNet in training mode on seeded random weights: float32
    parameters, DINOv2 frozen (no grad, so no optimizer state or decay),
    BatchNorms updating their running stats. ``remat`` recomputes the
    training forward's activations in the backward (RoMaNet)."""
    return init_random(build_net(config or RoMaConfig(), device, remat), seed).train()


def tiny_roma_v1_outdoor(weights=None, xfeat_weights=None, exact_softmax: bool = False,
                         dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0) -> TinyRoMa:
    """Tiny RoMa v1 (reference model_zoo/__init__.py:18-28). ``weights`` is
    tiny_roma_v1_outdoor.pth and ``xfeat_weights`` the XFeat hub checkpoint,
    each a path or a state dict, fetched when None; both or neither. With
    neither the net comes up on seeded random weights. ``dtype`` is the
    compute dtype (bfloat16: autocast over float32 parameters)."""
    if weights is None:
        weights = _fetch_state_dict(WEIGHT_URLS["tiny_roma_v1"]["outdoor"])
    if xfeat_weights is None:
        xfeat_weights = _fetch_state_dict(WEIGHT_URLS["xfeat"])
    if (weights is None) != (xfeat_weights is None):
        # a half-pretrained matcher matches nothing: fail loudly
        missing = "xfeat_weights" if xfeat_weights is None else "weights"
        raise RuntimeError(f"tiny_roma_v1_outdoor: {missing} unavailable while the companion checkpoint is "
                           "present; pass both (weights=..., xfeat_weights=...) or neither (random init).")
    with torch.device("meta"):
        net = TinyRoMaNet(exact_softmax=exact_softmax)
    net = net.to_empty(device=device)
    if weights is None:
        init_random(net, seed)
    else:
        convert.load_state(net, convert.convert_tiny_roma(_state_dict(weights), _state_dict(xfeat_weights)))
    return TinyRoMa(net, dtype=dtype, seed=seed)


def _roma_model(
    weights=None,
    dinov2_weights=None,
    coarse_res: int | tuple[int, int] = 560,
    upsample_res: int | tuple[int, int] = 864,
    symmetric: bool = True,
    upsample_preds: bool = True,
    attenuate_cert: bool = True,
    amp: bool = True,
    vit_gelu_tanh: bool | None = None,
    device="cuda",
    seed: int = 0,
    config: RoMaConfig | None = None,
    vit_int8: bool = False,
    refiner_int8: bool = False,
    variant: str | None = None,
) -> RegressionMatcher:
    """The big-RoMa matcher (reference model_zoo/roma_models.py:32-205).
    ``variant`` ("outdoor" / "indoor") names the released checkpoint to
    fetch when no weights are passed. Under ``amp`` the DINOv2 MLPs use the
    tanh GELU, as the JAX package's ``vit_gelu_tanh`` default does;
    ``vit_gelu_tanh=False`` keeps the exact erf even under amp.
    ``vit_int8`` / ``refiner_int8`` (or the config's) turn on the dynamic
    int8 serving paths (ops/int8.py) on the same weights."""
    config = config or RoMaConfig()
    if isinstance(coarse_res, int):
        coarse_res = (coarse_res, coarse_res)
    if isinstance(upsample_res, int):
        upsample_res = (upsample_res, upsample_res)
    if vit_gelu_tanh is None:
        vit_gelu_tanh = amp
    config = dataclasses.replace(config, vit_gelu_tanh=vit_gelu_tanh or config.vit_gelu_tanh,
                                 vit_int8=vit_int8 or config.vit_int8,
                                 refiner_int8=refiner_int8 or config.refiner_int8)
    if variant is not None and serving_knobs_off(config) == RELEASED:
        if weights is None:
            weights = _fetch_state_dict(WEIGHT_URLS["romatch"][variant])
        if weights is not None and dinov2_weights is None:
            dinov2_weights = _fetch_state_dict(WEIGHT_URLS["dinov2"])
    if (weights is None) != (dinov2_weights is None):
        # a half-pretrained matcher matches nothing: fail loudly
        missing = "dinov2_weights" if dinov2_weights is None else "weights"
        raise RuntimeError(f"roma_{variant or 'model'}: {missing} unavailable while the companion checkpoint is "
                           "present; pass both (weights=..., dinov2_weights=...) or neither (random init).")
    state = None if weights is None else convert.convert_roma(_state_dict(weights), _state_dict(dinov2_weights))
    net = build_net(config, device)
    if state is None:
        init_random(net, seed)
    else:
        convert.load_state(net, state)
    set_precision(net, torch.bfloat16 if amp else torch.float32)
    return RegressionMatcher(net, h=coarse_res[0], w=coarse_res[1], upsample_preds=upsample_preds,
                             symmetric=symmetric, attenuate_cert=attenuate_cert, upsample_res=upsample_res,
                             seed=seed)


def roma_outdoor(weights=None, dinov2_weights=None, coarse_res=560, upsample_res=864, **kw) -> RegressionMatcher:
    """RoMa outdoor (reference model_zoo/__init__.py:31-61); the arguments
    of :func:`_roma_model`."""
    return _roma_model(weights, dinov2_weights, coarse_res, upsample_res, variant="outdoor", **kw)


def roma_indoor(weights=None, dinov2_weights=None, coarse_res=560, upsample_res=864, **kw) -> RegressionMatcher:
    """RoMa indoor (reference model_zoo/__init__.py:64-94): the outdoor
    architecture; only the released weights differ."""
    return _roma_model(weights, dinov2_weights, coarse_res, upsample_res, variant="indoor", **kw)


def pretrained_backbone(net: RoMaNet, dinov2_weights=None, vgg_weights=None) -> RoMaNet:
    """Graft pretrained encoder weights into a :func:`train_net` network, in
    place, for a training run from scratch (counterpart of the JAX
    package's ``pretrained_backbone``): the reference always trains from
    torchvision's pretrained VGG19-BN and the pretrained frozen DINOv2
    (experiments/train_roma_outdoor.py:187), and a frozen random DINOv2
    cannot learn. ``dinov2_weights`` is dinov2_vitl14_pretrain.pth and
    ``vgg_weights`` torchvision's vgg19_bn weights (``features.*``), each a
    path or a state dict, fetched when None. Every tensor of ``encoder.cnn``
    and ``encoder.dinov2`` is replaced, its shape checked (ValueError).
    Offline without local files it prints a warning and returns ``net``
    unchanged."""
    def resolve(w, url):
        return _fetch_state_dict(url) if w is None else _state_dict(w)

    dino_sd, vgg_sd = resolve(dinov2_weights, WEIGHT_URLS["dinov2"]), resolve(vgg_weights, WEIGHT_URLS["vgg19_bn"])
    if dino_sd is None or vgg_sd is None:
        print(f"roma_tpu_torch: pretrained backbone unavailable (dinov2={'ok' if dino_sd else 'missing'}, "
              f"vgg={'ok' if vgg_sd else 'missing'}); the encoder stays randomly initialized, and a frozen random "
              "DINOv2 will not reproduce the reference training recipe.", file=sys.stderr)
        return net
    state = {**convert.convert_vgg19(vgg_sd, "features", net.config.vgg_channels), **convert.convert_dinov2(dino_sd)}
    return convert.load_state(net, state, prefixes=(convert.VGG_PREFIX + ".", convert.DINO_PREFIX))
