"""Kernel B's plain version (roma_tpu_torch.ops.local_correlation) against
the JAX package: the windowed Pallas kernel in interpret mode at r in {1, 2},
the XLA patch / corrvol paths at r in {3, 7}; and the wrapper's argument
checks (ops.local_corr.corr_checks) on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops.local_corr import local_correlation as jax_local_corr
from roma_tpu.ops.tile_window import CorrSpec, windowed_local_corr
from roma_tpu_torch.ops import local_correlation
from roma_tpu_torch.ops.local_corr import corr_checks
from torch_port_fixtures import flow_field
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

CSPEC = CorrSpec(th=8, tw=8, wh=24, xq=8, ns=4, pm=8, kf=4, nt_bad=8, cc=8)
ATOL = 1e-4  # C-long float32 dot products summed in another order


def _inputs(b, h, w, c, kind, seed):
    rs = np.random.RandomState(seed)
    f0 = rs.randn(b, h, w, c).astype(np.float32)
    f1 = rs.randn(b, h, w, c).astype(np.float32)
    return f0, f1, flow_field(h, w, b, kind, seed=seed)


def _port(f0, f1, r, flow):
    return local_correlation(torch.from_numpy(f0), torch.from_numpy(f1), r, torch.from_numpy(flow)).numpy()


@pytest.mark.parametrize("kind", ["smooth", "offimage", "speckle", "wild"])
@pytest.mark.parametrize("radius", [1, 2])
def test_local_corr_matches_windowed_interpret(kind, radius):
    f0, f1, flow = _inputs(2, 40, 40, 24, kind, radius)
    ref = windowed_local_corr(jnp.asarray(f0), jnp.asarray(f1), radius, jnp.asarray(flow),
                              spec=CSPEC, interpret=True)
    np.testing.assert_allclose(_port(f0, f1, radius, flow), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("radius,method", [(3, "patch"), (3, "corrvol"), (7, "corrvol"), (7, "patch")])
@pytest.mark.parametrize("kind", ["smooth", "offimage", "wild"])
def test_local_corr_matches_xla_paths(radius, method, kind):
    f0, f1, flow = _inputs(2, 20, 24, 32, kind, 10 + radius)
    ref = jax_local_corr(jnp.asarray(f0), jnp.asarray(f1), radius, jnp.asarray(flow), method=method)
    got = _port(f0, f1, radius, flow)
    assert got.shape == (2, 20, 24, (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def _corr_args(c=256, dtype=torch.bfloat16, b=1, h=6, w=7):
    return (torch.zeros(b, h, w, c, dtype=dtype), torch.zeros(b, h, w, c, dtype=dtype), 2,
            torch.zeros(b, h, w, 2))


@pytest.mark.parametrize("c,dtype,nv", [(256, torch.bfloat16, 1), (512, torch.bfloat16, 2),
                                        (1024, torch.bfloat16, 4), (64, torch.bfloat16, 1),
                                        (16, torch.float32, 1), (256, torch.float32, 2),
                                        (512, torch.float32, 4), (20, torch.bfloat16, 0),
                                        (2048, torch.bfloat16, 0), (7, torch.float32, 0)])
def test_corr_checks_pick_the_path(c, dtype, nv):
    assert corr_checks("t", *_corr_args(c, dtype)) == (1, 6, 7, c, nv)


def _shifted(c, dtype=torch.bfloat16):
    """A (1, 6, 7, C) view whose base is one element off 16 bytes."""
    flat = torch.zeros(6 * 7 * c + 1, dtype=dtype)
    return flat[1:].view(1, 6, 7, c)


def _with(i, value, c=256, dtype=torch.bfloat16):
    args = list(_corr_args(c, dtype))
    args[i] = value
    return args


CORR_FAULTS = {
    "float16 features": (_with(0, torch.zeros(1, 6, 7, 256, dtype=torch.float16)), TypeError),
    "f1 shape": (_with(1, torch.zeros(1, 6, 8, 256, dtype=torch.bfloat16)), ValueError),
    "f1 dtype": (_with(1, torch.zeros(1, 6, 7, 256)), ValueError),
    "warp dtype": (_with(3, torch.zeros(1, 6, 7, 2, dtype=torch.bfloat16)), ValueError),
    "warp shape": (_with(3, torch.zeros(1, 6, 7, 3)), ValueError),
    "negative radius": (_with(2, -1), ValueError),
    "strided f1": (_with(1, torch.zeros(1, 256, 6, 7, dtype=torch.bfloat16).permute(0, 2, 3, 1)), ValueError),
    "warp on another device": (_with(3, torch.zeros(1, 6, 7, 2, device="meta")), ValueError),
    "f0 base off 16 bytes": (_with(0, _shifted(256)), ValueError),
    "f1 base off 16 bytes, f32": (_with(1, _shifted(64, torch.float32), 64, torch.float32), ValueError),
    "f0 requires grad": (_with(0, torch.zeros(1, 6, 7, 256, dtype=torch.bfloat16, requires_grad=True)),
                         RuntimeError),
}


@pytest.mark.parametrize("fault", sorted(CORR_FAULTS))
def test_corr_checks_refuse(fault):
    args, err = CORR_FAULTS[fault]
    with pytest.raises(err):
        corr_checks("local_correlation", *args)


def test_corr_scalar_path_takes_any_base():
    assert corr_checks("t", *_with(1, _shifted(20), 20))[4] == 0


def test_corr_wrapper_refuses_before_any_launch_off_the_cpu():
    f = torch.zeros(1, 6, 7, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        local_correlation(f, f, 2, torch.zeros(1, 6, 7, 2, device="meta"))
    assert local_correlation.launches == 0
