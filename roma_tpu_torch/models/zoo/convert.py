"""Reference state dicts -> the port's parameters (counterpart of
roma_tpu/models/zoo/convert.py).

The released weights are torch ``.pth`` state dicts (reference
romatch/models/model_zoo/__init__.py:6-15): ``roma_outdoor.pth`` /
``roma_indoor.pth``, which hold everything but DINOv2 (the reference keeps
it out of its state dict), and ``dinov2_vitl14_pretrain.pth``; for Tiny
RoMa ``tiny_roma_v1_outdoor.pth``, which holds the two matchers (the
reference hides XFeat from its state dict, tiny.py:45), and the XFeat hub
weights. The port's modules carry the reference's names and layouts (OIHW
and depthwise (C, 1, K, K) convs, (out, in) Linears, BatchNorm running
statistics), so a roma or tiny key is the port's key as it is, a DINOv2 key
gains the prefix ``encoder.dinov2.`` and an XFeat key ``xfeat.``.
:func:`load_state` writes every port tensor once, with its shape checked,
and leaves no reference tensor unused.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..encoders import vgg19_conv_indices

DINO_PREFIX = "encoder.dinov2."
VGG_PREFIX = "encoder.cnn.layers"
# DINOv2's pretraining checkpoint also holds its masked-image-modeling
# token, which inference never reads
DINOV2_UNUSED = ("mask_token",)
XFEAT_PREFIX = "xfeat."
# the XFeat hub model's heads, which Tiny RoMa deletes (reference tiny.py:42)
XFEAT_HEADS = ("keypoint_head.", "heatmap_head.", "fine_matcher.")


def state_dict_to_numpy(sd) -> dict[str, np.ndarray]:
    """torch state dict -> {name: float32 numpy array}: unwraps a
    ``{"model": state dict}`` checkpoint and drops BatchNorm's
    ``num_batches_tracked``."""
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v, np.float32)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def convert_vgg19(sd, prefix: str, channels) -> dict:
    """A VGG19-BN state dict under ``prefix`` (torchvision's ``features``)
    at the config's ``vgg_channels`` -> the port's
    ``encoder.cnn.layers.*`` tensors of the convs and BatchNorms of
    ``features[:40]`` (:func:`vgg19_conv_indices`); the rest, torchvision's
    fifth stage and classifier, is not read."""
    out = {}
    for i in vgg19_conv_indices(channels):
        for idx, names in ((i, ("weight", "bias")), (i + 1, ("weight", "bias", "running_mean", "running_var"))):
            for n in names:
                out[f"{VGG_PREFIX}.{idx}.{n}"] = sd[f"{prefix}.{idx}.{n}"]
    return out


def convert_dinov2(sd) -> dict:
    """dinov2_vitl14_pretrain.pth -> the port's ``encoder.dinov2.*`` tensors."""
    return {DINO_PREFIX + k: v for k, v in sd.items() if k not in DINOV2_UNUSED}


def convert_roma(roma_sd, dinov2_sd) -> dict:
    """roma_outdoor/indoor.pth + dinov2_vitl14_pretrain.pth -> {port key:
    array} for :func:`load_state`."""
    dino = convert_dinov2(dinov2_sd)
    both = sorted(dino.keys() & roma_sd.keys())
    if both:
        raise KeyError(f"the roma state dict holds DINOv2 tensors too, e.g. {both[:3]}")
    return {**roma_sd, **dino}


def convert_tiny_roma(tiny_sd, xfeat_sd) -> dict:
    """tiny_roma_v1_outdoor.pth + the XFeat hub state dict -> {port key:
    array} for :func:`load_state`; XFeat's heads are dropped."""
    xfeat = {XFEAT_PREFIX + k: v for k, v in xfeat_sd.items() if not k.startswith(XFEAT_HEADS)}
    both = sorted(xfeat.keys() & tiny_sd.keys())
    if both:
        raise KeyError(f"the tiny state dict holds XFeat tensors too, e.g. {both[:3]}")
    return {**tiny_sd, **xfeat}


def load_state(net: nn.Module, sd: dict, prefixes: tuple[str, ...] = ("",)) -> nn.Module:
    """Fill ``net`` in place from {port key: array}: every port tensor whose
    key starts with one of ``prefixes`` written once, shapes checked, and
    no key of ``sd`` left over (KeyError, ValueError; nothing is written
    before every check passed); BatchNorm's ``num_batches_tracked`` there,
    which :func:`state_dict_to_numpy` drops, set to 0. Returns ``net``."""
    own = {k: v for k, v in net.state_dict().items() if k.startswith(prefixes)}
    target = {k: v for k, v in own.items() if not k.endswith("num_batches_tracked")}
    extra, missing = sorted(sd.keys() - target.keys()), sorted(target.keys() - sd.keys())
    if extra:
        raise KeyError(f"{len(extra)} reference tensors have no place in the port, e.g. {extra[:5]}")
    if missing:
        raise KeyError(f"{len(missing)} port tensors have no reference tensor, e.g. {missing[:5]}")
    for k, t in target.items():
        if tuple(np.shape(sd[k])) != tuple(t.shape):
            raise ValueError(f"{k}: the port's {tuple(t.shape)} vs the reference's {tuple(np.shape(sd[k]))}")
    with torch.no_grad():
        for k, t in own.items():
            t.copy_(torch.as_tensor(sd[k])) if k in target else t.zero_()
    return net


def to_reference(net: nn.Module, prefix: str = DINO_PREFIX) -> tuple[dict, dict]:
    """The inverse of :func:`convert_roma` (``prefix`` DINO_PREFIX) and of
    :func:`convert_tiny_roma` (XFEAT_PREFIX): ``net``'s tensors as a
    reference-layout pair (the roma or tiny state dict, the backbone's state
    dict) of float32 CPU tensors, as the released files hold them."""
    rest, backbone = {}, {}
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.to("cpu", torch.float32, copy=True)
        if k.startswith(prefix):
            backbone[k[len(prefix):]] = v
        else:
            rest[k] = v
    return rest, backbone
