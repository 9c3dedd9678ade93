"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py):
the JAX package's tiny-config variables refilled from a numpy seed, and the
port's RoMaNet holding the same weights."""
from __future__ import annotations

import numpy as np
import torch

import jax

from roma_tpu.models.config import RoMaConfig
from roma_tpu.models.roma import RegressionMatcher as JaxMatcher
from roma_tpu_torch.models.convert import from_jax_variables
from roma_tpu_torch.models.zoo import build_net

TINY = RoMaConfig.tiny()


def seeded_tiny_variables(seed: int = 0) -> dict:
    """JAX tiny RoMaNet variables as nested numpy dicts, every leaf refilled
    from ``seed``: LeCun-scaled kernels, perturbed norm scales and biases, BN
    running stats drawn away from (0, 1) so the folding is exercised."""
    shapes = JaxMatcher.init_variables(config=TINY, fast=True)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        shape = leaf.shape
        stacked = any(a == "block" and b in ("blocks", "hidden") for b, a in zip(names, names[1:]))
        last = names[-1]
        if last == "var":
            val = rs.uniform(0.8, 1.2, shape)
        elif last == "mean":
            val = rs.uniform(-0.2, 0.2, shape)
        elif last in ("scale", "gamma"):
            val = 1.0 + 0.1 * rs.randn(*shape)
        elif last == "bias":
            val = 0.1 * rs.randn(*shape)
        elif last == "kernel":
            fan = int(np.prod(shape[1 if stacked else 0:-1]))
            val = rs.randn(*shape) / np.sqrt(fan)
        else:  # cls_token, pos_embed
            val = 0.1 * rs.randn(*shape)
        return np.asarray(val, np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, filled)


def port_net(variables: dict) -> torch.nn.Module:
    """The port's float32 RoMaNet on the CPU holding ``variables``."""
    return from_jax_variables(variables, build_net(TINY, "cpu")).eval()


def flow_field(h, w, b, kind, seed=0):
    """The flow kinds of the JAX package's windowed-kernel tests."""
    rs = np.random.RandomState(seed)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    f = np.stack([gx, gy], -1)[None].repeat(b, 0)
    if kind == "smooth":
        f = f + 0.05 * rs.randn(b, h, w, 2)
    elif kind == "offimage":
        f = f + 0.05 * rs.randn(b, h, w, 2)
        f[:, : h // 3] -= 3.0  # top band fully out of image
    elif kind == "speckle":
        f = f + 0.03 * rs.randn(b, h, w, 2)
        sp = rs.rand(b, h, w) < 0.05
        f[..., 0] += np.where(sp, rs.randn(b, h, w), 0.0)
        f[..., 1] += np.where(sp, rs.randn(b, h, w), 0.0)
    elif kind == "wild":
        f = 2.5 * rs.randn(b, h, w, 2)
    return f.astype(np.float32)
