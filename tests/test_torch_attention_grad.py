"""Gradients of the port's attention (the plain backward that Kernel E is
checked against on the card) against jax.vjp of the JAX package's Pallas
attention, whose backward is _attn_bwd_kernel, in interpret mode: the packed
entry and the per-head entry, head dims 64 and 128, with and without the
n_valid key mask; and in bf16, the port's plain backward (which rounds P and
dS to bf16 for the second products, where Kernel E rounds them) against the
Pallas backward, whose products run in float32 from the same bf16 inputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from roma_tpu.ops.pallas_attention import fused_attention as jax_heads
from roma_tpu.ops.pallas_attention import fused_attention_packed as jax_packed
from roma_tpu_torch.ops import KERNEL_WRAPPERS, fused_attention, fused_attention_packed, sdpa
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

CASES = [(64, None), (128, None), (64, 187), (128, 187)]


def _tol(nv):
    # the bars of tests/test_ops.py:253-272 and :350-388
    return 1e-4 if nv is None else 1e-3


def _inputs(shape, nv, seq_axis, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32) * 0.5
    g = rs.randn(*shape[:-1], shape[-1] // (3 if len(shape) == 3 else 1)).astype(np.float32)
    if nv is not None:
        idx = [slice(None)] * len(shape)
        idx[seq_axis] = slice(nv, None)
        x[tuple(idx)] *= 5.0  # padded-token content must be inert
        g[tuple(idx)] = 0.0  # rows >= n_valid are don't-care
    return x, g


@pytest.mark.parametrize("d,nv", CASES)
def test_packed_attention_grad_matches_pallas_interpret(d, nv):
    b, n, c = 2, 256, 256
    heads = c // d
    qkv, g = _inputs((b, n, 3 * c), nv, 1, seed=d)
    with pltpu.force_tpu_interpret_mode():
        ref_out, vjp = jax.vjp(lambda x: jax_packed(x, heads, n_valid=nv), jnp.asarray(qkv))
        (ref,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = fused_attention_packed(x, heads, nv)
    out.backward(torch.from_numpy(g))
    m = nv or n
    np.testing.assert_allclose(out.detach().numpy()[:, :m], np.asarray(ref_out)[:, :m], atol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=_tol(nv))
    assert all(f.launches == 0 for f in KERNEL_WRAPPERS)  # CPU tensors never launch


@pytest.mark.parametrize("d,nv", CASES)
def test_per_head_attention_grad_matches_pallas_interpret(d, nv):
    shape = (1, 2, 200 if nv is None else 256, d)
    q, g = _inputs(shape, nv, 2, seed=d + 1)
    k, _ = _inputs(shape, nv, 2, seed=d + 2)
    v, _ = _inputs(shape, nv, 2, seed=d + 3)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: jax_heads(q, k, v, n_valid=nv),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    fused_attention(*ts, nv).backward(torch.from_numpy(g))
    for name, t, ref in zip("qkv", ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=_tol(nv), err_msg=f"d{name}")
    # on the CPU sdpa is the einsum form, differentiated by autograd
    ts2 = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    sdpa(*ts2, nv).backward(torch.from_numpy(g))
    for t, t2 in zip(ts, ts2):
        np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), atol=1e-5)
    assert all(f.launches == 0 for f in KERNEL_WRAPPERS)


# bf16: the port rounds P and dS to bf16 before p^T dout, ds k and ds^T q (as
# Kernel E does on the tensor cores); the Pallas backward keeps them float32.
# Measured on the CPU at these inputs: the gradients differ by at most
# 6.5e-3 of each gradient's largest entry (dq, dk; dv 6.3e-3), against
# 4e-4..4e-3 when the port's backward does not round (a bf16 ulp is 2^-8 of
# a value's leading power of two, so this is about one ulp of the largest
# entry). The bar: 1e-2 of each gradient's largest entry.
BF16_GRAD_TOL = 1e-2


@pytest.mark.parametrize("d,nv", CASES)
def test_packed_attention_grad_bf16_matches_pallas_interpret(d, nv):
    b, n, c = 2, 256, 256
    heads = c // d
    qkv, g = _inputs((b, n, 3 * c), nv, 1, seed=d)
    qkv_b, g_b = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x: jax_packed(x, heads, n_valid=nv), qkv_b)
        (ref,) = vjp(g_b)
    ref = np.asarray(ref.astype(jnp.float32))
    to_torch = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    x = to_torch(qkv_b).requires_grad_(True)
    fused_attention_packed(x, heads, nv).backward(to_torch(g_b))
    assert x.grad.dtype == torch.bfloat16
    got = x.grad.float().numpy()
    for i, name in enumerate(("dq", "dk", "dv")):
        r, gg = ref[..., i * c:(i + 1) * c], got[..., i * c:(i + 1) * c]
        err = np.abs(gg - r).max() / np.abs(r).max()
        assert err <= BF16_GRAD_TOL, f"{name}: {err:.3e} of its largest entry"
    assert all(f.launches == 0 for f in KERNEL_WRAPPERS)
