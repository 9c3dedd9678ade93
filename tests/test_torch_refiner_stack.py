"""Kernel D's plain version (roma_tpu_torch.ops.fused_refiner_stack) against
the JAX package's channel-major Pallas refiner kernel in interpret mode, the
port's BatchNorm folding against its unfolded eval-mode modules, the
ConvRefiner's cache of its folded blocks, and the wrapper's argument checks
(ops.refiner_stack.stack_checks), all on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import pallas_refiner as pr
from roma_tpu_torch.models import matcher
from roma_tpu_torch.models.blocks import nhwc, refiner_block
from roma_tpu_torch.models.config import RefinerSpec
from roma_tpu_torch.models.matcher import ConvRefiner
from roma_tpu_torch.ops import fold_block, fold_refiner, fused_refiner_stack
from roma_tpu_torch.ops.refiner_stack import stack_checks
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

ATOL = 1e-4


def _torch_params(c, n, seed=0):
    """n blocks of torch-layout refiner params (conv1, BN, conv2)."""
    rs = np.random.RandomState(seed)
    f = lambda *s, scale=1.0, shift=0.0: (shift + scale * rs.randn(*s)).astype(np.float32)
    return [
        dict(
            dw_weight=f(c, 1, 5, 5, scale=0.2), dw_bias=f(c, scale=0.1),
            bn_weight=f(c, scale=0.1, shift=1.0), bn_bias=f(c, scale=0.1),
            bn_mean=f(c, scale=0.05), bn_var=np.abs(f(c, scale=0.2, shift=1.0)),
            pw_weight=f(c, c, 1, 1, scale=1.5 / np.sqrt(c)), pw_bias=f(c, scale=0.1),
        )
        for _ in range(n)
    ]


def _jax_fold(p):
    """The same params in flax layouts through the JAX package's fold_block."""
    return pr.fold_block(
        jnp.asarray(p["dw_weight"].transpose(2, 3, 1, 0)), jnp.asarray(p["dw_bias"]),
        jnp.asarray(p["bn_weight"]), jnp.asarray(p["bn_bias"]),
        jnp.asarray(p["bn_mean"]), jnp.asarray(p["bn_var"]),
        jnp.asarray(p["pw_weight"].transpose(2, 3, 1, 0)), jnp.asarray(p["pw_bias"]),
    )


@pytest.mark.parametrize("h,w", [(18, 22), (40, 31)])
def test_refiner_stack_matches_pallas_interpret(h, w):
    c, nb = 24, 9
    params = _torch_params(c, nb)
    jblocks = [_jax_fold(p) for p in params]
    tblocks = [fold_block(**{k: torch.from_numpy(v) for k, v in p.items()}) for p in params]
    for jb, tb in zip(jblocks, tblocks):
        for k in ("dw", "db", "w2", "b2"):
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=1e-6, atol=1e-7)
    x = np.random.RandomState(1).randn(2, h, w, c).astype(np.float32)
    ref = np.asarray(pr.fused_refiner_stack(jnp.asarray(x), jblocks, interpret=True))
    got = fused_refiner_stack(torch.from_numpy(x), tblocks).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert fused_refiner_stack.launches == 0


def test_fold_matches_unfolded_modules():
    c, nb = 24, 3
    blocks = [refiner_block(c, c) for _ in range(nb)]
    for seq, p in zip(blocks, _torch_params(c, nb, seed=2)):
        conv1, bn, _, conv2 = seq
        with torch.no_grad():
            conv1.weight.copy_(torch.from_numpy(p["dw_weight"]))
            conv1.bias.copy_(torch.from_numpy(p["dw_bias"]))
            bn.weight.copy_(torch.from_numpy(p["bn_weight"]))
            bn.bias.copy_(torch.from_numpy(p["bn_bias"]))
            bn.running_mean.copy_(torch.from_numpy(p["bn_mean"]))
            bn.running_var.copy_(torch.from_numpy(p["bn_var"]))
            conv2.weight.copy_(torch.from_numpy(p["pw_weight"]))
            conv2.bias.copy_(torch.from_numpy(p["pw_bias"]))
        seq.eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 17, 23, c).astype(np.float32))
    with torch.no_grad():
        ref = x
        for seq in blocks:
            ref = nhwc(seq, ref)
        got = fused_refiner_stack(x, fold_refiner(blocks[0], blocks[1:]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def _refiner(seed=4, c=24, n_hidden=2):
    """An eval-mode ConvRefiner of width c on seeded weights and BN stats."""
    torch.manual_seed(seed)
    ref = ConvRefiner(RefinerSpec(in_dim=c, hidden_dim=c, disp_emb_dim=6, hidden_blocks=n_hidden))
    with torch.no_grad():
        for seq in (ref.block1, *ref.hidden_blocks):
            seq[1].running_mean.uniform_(-0.2, 0.2)
            seq[1].running_var.uniform_(0.8, 1.2)
            seq[1].weight.uniform_(0.9, 1.1)
    return ref.eval()


def _count_folds(monkeypatch):
    calls = []

    def counting(*a):
        calls.append(1)
        return fold_refiner(*a)

    monkeypatch.setattr(matcher, "fold_refiner", counting)
    return calls


def test_fold_cache_reuses_the_folded_blocks(monkeypatch):
    ref, calls = _refiner(), _count_folds(monkeypatch)
    first = ref.folded_blocks()
    with torch.inference_mode():
        second = ref.folded_blocks()
    assert len(calls) == 1 and second is first
    # folded outside inference mode: usable where autograd is on
    assert not any(t.is_inference() for blk in first for t in blk.values())


@pytest.mark.parametrize("change", ["copy_", "add_", "load_state_dict", "running_stats", "to_bf16"])
def test_fold_cache_refolds_on_a_change(monkeypatch, change):
    ref = _refiner()
    before = [{k: v.clone() for k, v in blk.items()} for blk in ref.folded_blocks()]
    calls = _count_folds(monkeypatch)
    conv1 = ref.hidden_blocks[1][0]
    with torch.no_grad():
        if change == "copy_":
            conv1.weight.copy_(2 * conv1.weight)
        elif change == "add_":
            ref.block1[3].bias.add_(1.0)
        elif change == "load_state_dict":
            sd = {k: v.clone() for k, v in ref.state_dict().items()}
            sd["block1.3.weight"] *= 3
            ref.load_state_dict(sd)
        elif change == "running_stats":  # a training-mode forward moves them
            ref.train()
            ref.block1[1](torch.randn(2, 24, 5, 5))
            ref.eval()
        else:
            ref.to(torch.bfloat16)
    after = ref.folded_blocks()
    assert len(calls) == 1
    assert any(not torch.equal(a[k], b[k]) for a, b in zip(after, before) for k in a)
    again = ref.folded_blocks()
    assert len(calls) == 1 and again is after


def test_refiner_forward_with_the_cache_matches_the_modules():
    """The eval-mode ConvRefiner's stack (the cached fold through Kernel D's
    plain version) against its unfolded modules, called twice."""
    ref = _refiner()
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 11, 13, 24).astype(np.float32))
    with torch.no_grad():
        want = x
        for seq in (ref.block1, *ref.hidden_blocks):
            want = nhwc(seq, want)
        for _ in range(2):
            got = fused_refiner_stack(x, ref.folded_blocks())
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def _blocks(c, k, n=2, device="cpu"):
    return [{"dw": torch.zeros(k, k, c, device=device), "db": torch.zeros(c, device=device),
             "w2": torch.zeros(c, c, device=device), "b2": torch.zeros(c, device=device)} for _ in range(n)]


def test_stack_checks_pick_the_instantiation():
    x = torch.zeros(2, 9, 10, 24)
    assert stack_checks("t", x, _blocks(24, 5))[4] == [(5, "c24k5")] * 2
    assert stack_checks("t", x, _blocks(24, 3))[4] == [(3, "generic")] * 2
    assert stack_checks("t", torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16), _blocks(16, 5))[:4] == (1, 4, 4, 16)
    # the generic instantiation takes a base off 16 bytes
    flat = torch.zeros(16 * 16 * 20 + 1, dtype=torch.bfloat16)
    assert stack_checks("t", flat[1:].view(1, 16, 16, 20), _blocks(20, 5))[4][0] == (5, "generic")


def _misaligned_x():
    flat = torch.zeros(16 * 16 * 24 + 1, dtype=torch.bfloat16)
    return flat[1:].view(1, 16, 16, 24)


def _bad_block(**kw):
    blk = _blocks(24, 5, 1)[0]
    blk.update(kw)
    return [blk]


STACK_FAULTS = {
    "C above 32": (lambda: torch.zeros(1, 4, 4, 33), lambda: _blocks(33, 5), ValueError),
    "float16 x": (lambda: torch.zeros(1, 4, 4, 24, dtype=torch.float16), lambda: _blocks(24, 5), TypeError),
    "even K": (lambda: torch.zeros(1, 4, 4, 24), lambda: _blocks(24, 4), ValueError),
    "w2 shape": (lambda: torch.zeros(1, 4, 4, 24), lambda: _bad_block(w2=torch.zeros(24, 16)), ValueError),
    "bf16 weights": (lambda: torch.zeros(1, 4, 4, 24),
                     lambda: _bad_block(db=torch.zeros(24, dtype=torch.bfloat16)), ValueError),
    "strided weights": (lambda: torch.zeros(1, 4, 4, 24), lambda: _bad_block(w2=torch.zeros(24, 24).T), ValueError),
    "weights on another device": (lambda: torch.zeros(1, 4, 4, 24), lambda: _blocks(24, 5, device="meta"),
                                  ValueError),
    "strided x": (lambda: torch.zeros(1, 24, 4, 4).permute(0, 2, 3, 1), lambda: _blocks(24, 5), ValueError),
    "x base off 16 bytes": (_misaligned_x, lambda: _blocks(24, 5), ValueError),
    "x requires grad": (lambda: torch.zeros(1, 4, 4, 24, requires_grad=True), lambda: _blocks(24, 5),
                        RuntimeError),
}


@pytest.mark.parametrize("fault", sorted(STACK_FAULTS))
def test_stack_checks_refuse(fault):
    make_x, make_blocks, err = STACK_FAULTS[fault]
    with pytest.raises(err):
        stack_checks("fused_refiner_stack", make_x(), make_blocks())


def test_wrapper_refuses_before_any_launch_off_the_cpu():
    """A meta tensor is neither CPU nor CUDA: refused before the kernel
    library is touched (this box has no nvcc to build it)."""
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        fused_refiner_stack(torch.zeros(1, 4, 4, 24, device="meta"), _blocks(24, 5, device="meta"))
    assert fused_refiner_stack.launches == 0
