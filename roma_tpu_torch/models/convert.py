"""JAX variables -> port state dict (the inverse of the mappings in
roma_tpu/models/zoo/convert.py).

``tree`` is the JAX package's ``{"params", "batch_stats"}`` variables as
nested dicts of numpy arrays. Flax conv kernels are HWIO and become OIHW
(depthwise (K, K, 1, C) -> (C, 1, K, K)); Dense kernels (in, out) become
Linear (out, in); the scan-stacked ``blocks/block`` and ``hidden/block``
leaves are unstacked along axis 0; BatchNorm ``mean``/``var`` become
``running_mean``/``running_var``. Every port tensor must be written exactly
once, with the right shape, and no JAX leaf may be left over.

:func:`to_port_layout` carries any tree of that shape, such as the JAX
package's gradients, into the port's names and layouts, so the tests compare
gradients leaf by leaf.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# module renames on the "/"-joined JAX path -> port module path
_RENAMES = [
    (r"^encoder/vgg/(?:conv|bn)(\d+)/", r"encoder/cnn/layers/\1/"),
    (r"/patch_embed/", r"/patch_embed/proj/"),
    (r"/gp16/", r"/gps/16/"),
    (r"/proj(\d+)_conv/", r"/proj/\1/0/"),
    (r"/proj(\d+)_bn/", r"/proj/\1/1/"),
    (r"/refiner(\d+)/", r"/conv_refiner/\1/"),
    (r"(/block1|/hidden_blocks/\d+)/conv1/", r"\1/0/"),
    (r"(/block1|/hidden_blocks/\d+)/bn/", r"\1/1/"),
    (r"(/block1|/hidden_blocks/\d+)/conv2/", r"\1/3/"),
]
_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
_STACKED = {"blocks/block": "blocks", "hidden/block": "hidden_blocks"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _entries(tree):
    """Yield (port_key, jax_path, leaf, stack_index, permutation) per tensor."""
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(tree.get(coll, {})):
            jpath = "/".join(path)
            stacked = [k for k in _STACKED if f"/{k}/" in f"/{jpath}"]
            indices = range(leaf.shape[0]) if stacked else [None]
            for i in indices:
                p = jpath
                if stacked:
                    p = p.replace(stacked[0], f"{_STACKED[stacked[0]]}/{i}")
                for pat, rep in _RENAMES:
                    p = re.sub(pat, rep, p)
                head, _, last = p.rpartition("/")
                key = (head + "/" if head else "") + _LEAVES.get(last, last)
                ndim = len(leaf.shape) - (1 if stacked else 0)
                perm = None
                if last == "kernel":
                    perm = (3, 2, 0, 1) if ndim == 4 else (1, 0)
                yield key.replace("/", "."), f"{coll}/{jpath}", leaf, i, perm


def _port_value(leaf, i, perm) -> np.ndarray:
    val = np.asarray(leaf, np.float32)
    val = val[i] if i is not None else val
    return np.ascontiguousarray(val.transpose(perm) if perm is not None else val)


def to_port_layout(tree: dict) -> dict[str, np.ndarray]:
    """A ``{"params", "batch_stats"}``-shaped tree of arrays (either
    collection may be absent, e.g. ``{"params": grads}``) -> {port state-dict
    key: float32 array in the port's layout}."""
    return {key: _port_value(leaf, i, perm) for key, _, leaf, i, perm in _entries(tree)}


def _port_tensors(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def _apply(tree, model, write: bool):
    sd = _port_tensors(model)
    written = set()
    for key, jpath, leaf, i, perm in _entries(tree):
        if key not in sd:
            raise KeyError(f"JAX leaf {jpath} maps to {key}, which the model does not have")
        if key in written:
            raise KeyError(f"{key} written twice (JAX leaf {jpath})")
        shape = tuple(leaf.shape[1:] if i is not None else leaf.shape)
        if perm is not None:
            shape = tuple(shape[j] for j in perm)
        if tuple(sd[key].shape) != shape:
            raise ValueError(f"{key}: model {tuple(sd[key].shape)} vs JAX {jpath} -> {shape}")
        if write:
            with torch.no_grad():
                sd[key].copy_(torch.from_numpy(_port_value(leaf, i, perm)))
        written.add(key)
    missing = sorted(set(sd) - written)
    if missing:
        raise KeyError(f"{len(missing)} model tensors have no JAX leaf, e.g. {missing[:5]}")
    return written


def from_jax_variables(tree: dict, model: torch.nn.Module) -> torch.nn.Module:
    """Fill ``model`` (a RoMaNet) in place from JAX variables; returns it."""
    _apply(tree, model, write=True)
    return model


def check_jax_shapes(tree: dict, model: torch.nn.Module) -> int:
    """Coverage and shape check only; leaves need just ``.shape`` (e.g.
    ``jax.eval_shape`` output) and the model may live on the meta device.
    Returns the number of port tensors covered."""
    return len(_apply(tree, model, write=False))
