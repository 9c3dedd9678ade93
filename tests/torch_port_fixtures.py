"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py):
the JAX package's tiny-config variables refilled from a numpy seed, and the
port's RoMaNet holding the same weights; the same for Tiny RoMa (the XFeat
matcher, not the tiny config of big RoMa); and the one-torch-thread module
fixture.

JAX and the JAX package are imported on first use (``TINY`` and the seeded
variables), so a test file that takes only the fixture, or ``flow_field``,
runs where JAX is not installed (the card's tests)."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from roma_tpu_torch.models.convert import from_jax_variables
from roma_tpu_torch.models.tiny import TinyRoMaNet
from roma_tpu_torch.models.zoo import build_net


@functools.cache
def _tiny():
    from roma_tpu.models.config import RoMaConfig

    return RoMaConfig.tiny()


def __getattr__(name):
    if name == "TINY":  # the JAX package's tiny config
        return _tiny()
    raise AttributeError(name)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in the module that imports this fixture: the tier
    runs several test processes at once, and torch's thread pools in each
    spin against the others' (test_torch_smoke_checks.py's planted cases
    took 50-86 s a test under the tier against 0.15 s alone)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def seeded_tiny_variables(seed: int = 0) -> dict:
    """JAX tiny RoMaNet variables as nested numpy dicts, every leaf refilled
    from ``seed``: LeCun-scaled kernels, perturbed norm scales and biases, BN
    running stats drawn away from (0, 1) so the folding is exercised."""
    import jax
    from roma_tpu.models.roma import RegressionMatcher as JaxMatcher

    shapes = JaxMatcher.init_variables(config=_tiny(), fast=True)
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


def seeded_tiny_roma_variables(seed: int = 0) -> dict:
    """JAX TinyRoMaNet variables as nested numpy dicts, refilled from
    ``seed``: He-scaled conv kernels (the activations keep their scale
    through the ReLUs, so the global correlation is not flat), biases
    0.1 N(0, 1), BN running stats drawn away from (0, 1)."""
    import jax
    from roma_tpu.models.tiny import TinyRoMa as JaxTinyRoMa

    shapes = JaxTinyRoMa.init_variables(fast=True)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        last, shape = str(getattr(path[-1], "key", path[-1])), leaf.shape
        if last == "var":
            val = rs.uniform(0.8, 1.2, shape)
        elif last == "mean":
            val = rs.uniform(-0.2, 0.2, shape)
        elif last == "bias":
            val = 0.1 * rs.randn(*shape)
        else:  # conv kernels, HWIO
            val = rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        return np.asarray(val, np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def port_tiny_net(variables: dict, **kw) -> TinyRoMaNet:
    """The port's float32 TinyRoMaNet on the CPU holding ``variables``, in
    eval mode unless ``train_mode=True`` is passed."""
    return from_jax_variables(variables, TinyRoMaNet(**kw))


def port_net(variables: dict) -> torch.nn.Module:
    """The port's float32 RoMaNet on the CPU holding ``variables``."""
    return from_jax_variables(variables, build_net(_tiny(), "cpu")).eval()


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
