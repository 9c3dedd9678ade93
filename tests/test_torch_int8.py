"""The port's int8 serving path (roma_tpu_torch/ops/int8.py, QLinear,
QConv1x1, the vit_int8 / refiner_int8 knobs) against the JAX package's, on
the CPU.

Bars. ``int8_matmul`` is the JAX formula step for step and is held to JAX's
output bit for bit, at the ViT's and every refiner width, in float32 and
bfloat16. The modules and the matcher are held to JAX with the same weights,
where float differences upstream of an int8 layer (~1e-6) can move an
activation across a rounding boundary and flip one int8 value. Each int8
layer's inputs are recorded on both sides (forward pre-hooks here,
``nn.intercept_methods`` with a debug callback in JAX), and the port runs
twice. Once with each int8 layer fed JAX's recorded input (no flip can
happen): held to the float bar FLOAT_ATOL (the float paths differ by ~2e-6
at these sizes), so every int8 layer computes JAX's values. Once on its own
inputs: the flipped int8 values are counted, at most MAX_FLIP_SHARE of them,
and the outputs held to FLIP_ATOL, since one flip moves a layer's output by
up to a quantization step and the matcher carries it on (measured: 43 flips
of ~1e6 values moved a certainty by 4.6e-3, over the port's float parity bar
of 2e-3, tests/test_roma_parity.py:427-437).
"""
from __future__ import annotations

import dataclasses
import importlib

import flax.linen as fnn
import numpy as np
import pytest
import torch
from torch_port_fixtures import TINY as JAX_TINY
from torch_port_fixtures import seeded_tiny_variables

import jax
import jax.numpy as jnp
from roma_tpu.models.blocks import QConv1x1 as JaxQConv1x1
from roma_tpu.models.matcher import RefinerBlock as JaxRefinerBlock
from roma_tpu.models.matcher import RoMaNet as JaxNet
from roma_tpu.models.vit import DinoV2 as JaxDinoV2
from roma_tpu.models.vit import QDense
from roma_tpu.ops.int8 import int8_matmul as jax_int8_matmul
from roma_tpu_torch.models import RoMaConfig, roma_outdoor, train_net
from roma_tpu_torch.models import zoo
from roma_tpu_torch.models.blocks import QConv1x1, nhwc, refiner_block
from roma_tpu_torch.models.convert import from_jax_variables
from roma_tpu_torch.models.vit import QLinear
from roma_tpu_torch.ops import int8 as int8_ops
from roma_tpu_torch.ops.int8 import int8_matmul, padded_int_mm, quantize
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

FLOAT_ATOL = 1e-4
FLIP_ATOL = 1e-2
MAX_FLIP_SHARE = 1e-3
TINY = RoMaConfig.tiny()
INT8 = dataclasses.replace(TINY, vit_int8=True, refiner_int8=True)
JAX_INT8 = dataclasses.replace(JAX_TINY, vit_int8=True, refiner_int8=True)
# the ViT's proj / fc1 / fc2 at 560^2 (1601 tokens) and the refiners' widths
# (RoMaConfig().refiner_specs(): 1377, 1137, 569, 144)
SHAPES = [(64, 256, 128), (1601, 1024, 4096), (300, 1377, 1377), (300, 1137, 1137), (300, 569, 569),
          (300, 144, 144)]


def _operands(m, k, n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32) * rs.uniform(0.1, 3, (m, 1)).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    return x, w, (0.1 * rs.randn(n)).astype(np.float32)


def _both(x, w, b, dtype):
    """JAX's and the port's int8_matmul on the same operands, as float32
    numpy (bfloat16 results widen exactly)."""
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b)).astype(jnp.float32))
    got = int8_matmul(torch.from_numpy(x).to(td), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == td
    return got.float().numpy(), ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_matmul_is_jax_bit_for_bit(shape, dtype):
    got, ref = _both(*_operands(*shape), dtype)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_extreme_rows_are_jax_bit_for_bit(dtype):
    """Rows of zeros (the 1e-12 scale floor), 1e-30 beside 1e6 (the small
    value rounds to 0), and a row of equal values: JAX's tests' rows."""
    x, w, b = _operands(8, 64, 24, seed=1)
    x[0] = 0.0
    x[1, :] = 1e-30
    x[1, 5] = 1e6
    x[2] = 0.5
    x[3, ::2] = -x[3, 1::2]
    got, ref = _both(x, w, b, dtype)
    assert np.array_equal(got, ref)
    assert np.array_equal(got[0], np.asarray(jnp.asarray(b, jnp.float32 if dtype == "float32" else jnp.bfloat16)
                                             .astype(jnp.float32)))


@pytest.mark.parametrize("m,k,n", [(4, 1377, 1377), (16, 1137, 1137), (3, 569, 569), (17, 144, 144), (2, 7, 5),
                                   (40, 1024, 3072)])
def test_the_cards_padding_is_exact(m, k, n):
    """padded_int_mm, the card's form of the product (K and N padded to
    multiples of 8, the rows past 16), equals the unpadded product."""
    rs = np.random.RandomState(m + k)
    xq = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rs.randint(-127, 128, (n, k)).astype(np.int8))
    got = padded_int_mm(xq, wq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, xq.long().matmul(wq.long().t()).int())


def test_a_refused_product_raises_and_never_falls_back(monkeypatch):
    def refuse(a, b):
        raise RuntimeError("_int_mm: shape refused")

    monkeypatch.setattr(int8_ops.torch, "_int_mm", refuse)
    x, w, b = _operands(20, 32, 16)
    with pytest.raises(RuntimeError, match="refused"):
        int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    layer = QLinear(32, 16, int8=True)
    with pytest.raises(RuntimeError, match="refused"):
        layer(torch.from_numpy(x))


def test_q_modules_keep_linear_and_conv_parameters():
    ql, lin = QLinear(24, 40, int8=True), torch.nn.Linear(24, 40)
    qc, conv = QConv1x1(24, 40), torch.nn.Conv2d(24, 40, 1)
    for q, ref in ((ql, lin), (qc, conv)):
        sq, sr = q.state_dict(), ref.state_dict()
        assert list(sq) == list(sr) and all(sq[k].shape == sr[k].shape for k in sr)
        q.load_state_dict(sr)  # strict
    blk, flt = refiner_block(24, 24, 5, int8=True), refiner_block(24, 24, 5)
    assert isinstance(blk[3], QConv1x1) and type(flt[3]) is torch.nn.Conv2d
    assert {k: v.shape for k, v in blk.state_dict().items()} == {k: v.shape for k, v in flt.state_dict().items()}


def test_the_cached_int8_weight_follows_the_weight():
    """QLinear's int8 weight equals a fresh quantization after copy_,
    load_state_dict and a cast: the cache is keyed on the tensor's version."""
    torch.manual_seed(0)
    layer = QLinear(16, 8, int8=True)
    x = torch.randn(5, 16)
    def scale():
        with torch.no_grad():
            layer.weight.mul_(2.0)  # as an optimizer step writes it

    changes = ((scale, True),
               (lambda: layer.load_state_dict(torch.nn.Linear(16, 8).state_dict()), True),
               (lambda: layer.double().float(), False))
    for change, alters in changes:
        before, cached = layer(x), layer._quantized.value
        change()
        assert torch.equal(layer(x), int8_matmul(x, layer.weight.t(), layer.bias))
        assert layer._quantized.value is not cached
        assert torch.equal(layer(x), before) != alters


# ---------------------------------------------------------------------------
# the modules and the matcher against JAX, flips counted
# ---------------------------------------------------------------------------


def _quantized(a: np.ndarray) -> np.ndarray:
    """The int8 values of ``a``'s rows (last axis), as int8_matmul forms them."""
    t = torch.from_numpy(np.array(a, np.float32)).reshape(-1, a.shape[-1])
    return quantize(t, dim=1)[0].numpy()


def _jax_int8_inputs(fn):
    """Run ``fn`` and record the input of every QDense / QConv1x1 call, in
    call order (a debug callback, so scanned blocks report each layer)."""
    seen = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, (QDense, JaxQConv1x1)) and context.method_name == "__call__":
            jax.debug.callback(lambda x: seen.append(np.asarray(x, np.float32)), args[0])
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        out = fn()
    jax.effects_barrier()
    return out, seen


def _port_int8_inputs(module: torch.nn.Module, fn, forced=None):
    """Run ``fn`` under no_grad and record the input of every int8 layer
    under ``module`` (NHWC for a QConv1x1), in call order; with ``forced``
    (JAX's recorded inputs) each layer takes JAX's input in place of its own."""
    seen = []

    def hook(mod, args):
        x = args[0]
        conv = isinstance(mod, QConv1x1)
        seen.append((x.permute(0, 2, 3, 1) if conv else x).float().numpy().copy())
        if forced is not None:
            j = torch.from_numpy(forced[len(seen) - 1].copy())
            j = j.permute(0, 3, 1, 2) if conv else j[:, : x.shape[1]]  # JAX pads the ViT's tokens
            return (j.to(x.dtype),)

    hooks = [m.register_forward_pre_hook(hook) for m in module.modules()
             if isinstance(m, QConv1x1) or (isinstance(m, QLinear) and m.int8)]
    try:
        with torch.no_grad():
            out = fn()
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def _flips(port_inputs, jax_inputs) -> tuple[int, int]:
    """(flipped int8 values, int8 values) over the layers' calls; JAX's ViT
    pads its tokens to a multiple of 128, so only the port's rows count."""
    assert len(port_inputs) == len(jax_inputs) > 0
    flips = total = 0
    for p, j in zip(port_inputs, jax_inputs):
        if p.shape != j.shape:  # (B, N, C) against JAX's (B, Npad, C)
            j = j[:, : p.shape[1]]
        assert p.shape == j.shape
        qp, qj = _quantized(p), _quantized(j)
        flips += int((qp != qj).sum())
        total += qp.size
    return flips, total


def _hold_to_jax(module, port_fn, jax_fn, outputs, what) -> list:
    """The two port runs against JAX's (module docstring); ``outputs`` maps
    a run's result to {name: array}. Returns the port's int8 inputs."""
    ref, jax_in = _jax_int8_inputs(jax_fn)
    ref = outputs(ref)
    forced, _ = _port_int8_inputs(module, port_fn, forced=jax_in)
    got, port_in = _port_int8_inputs(module, port_fn)
    flips, total = _flips(port_in, jax_in)
    assert flips <= MAX_FLIP_SHARE * total, f"{what}: {flips} of {total} int8 values flipped"
    for run, bar in ((outputs(forced), FLOAT_ATOL), (outputs(got), FLOAT_ATOL if flips == 0 else FLIP_ATOL)):
        assert run.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(run[k], ref[k], atol=bar, rtol=0,
                                       err_msg=f"{what} {k} ({flips} of {total} int8 values flipped, bar {bar})")
    return port_in


@pytest.fixture(scope="module")
def variables():
    return seeded_tiny_variables(0)


@pytest.fixture(scope="module")
def int8_net(variables):
    return from_jax_variables(variables, zoo.build_net(INT8, "cpu")).eval()


def test_dinov2_int8_matches_jax(variables, int8_net):
    x = np.random.RandomState(1).randn(2, 70, 56, 3).astype(np.float32)
    dino = int8_net.encoder.dinov2
    jmod = JaxDinoV2(embed_dim=TINY.dino_dim, depth=TINY.dino_depth, num_heads=TINY.dino_heads, int8=True)
    port_in = _hold_to_jax(dino, lambda: dino(torch.from_numpy(x)),
                           lambda: jmod.apply({"params": variables["params"]["encoder"]["dinov2"]}, jnp.asarray(x)),
                           lambda out: {"tokens": np.asarray(out)}, "DINOv2 int8")
    assert len(port_in) == 3 * TINY.dino_depth  # proj, fc1, fc2 a block; qkv stays float


def test_refiner_block_int8_matches_jax(variables, int8_net):
    scale = "16"
    c = TINY.refiner_specs()[16].hidden_dim
    blk = int8_net.decoder.conv_refiner[scale].block1
    assert isinstance(blk[3], QConv1x1)
    h = np.random.RandomState(2).randn(2, 13, 11, c).astype(np.float32)
    jv = {coll: variables[coll]["decoder"][f"refiner{scale}"]["block1"] for coll in ("params", "batch_stats")}
    port_in = _hold_to_jax(blk, lambda: nhwc(blk, torch.from_numpy(h)),
                           lambda: JaxRefinerBlock(out_dim=c, int8=True).apply(jv, jnp.asarray(h)),
                           lambda out: {"out": np.asarray(out)}, "refiner block int8")
    assert len(port_in) == 1


def _int8_matcher(variables):
    m = roma_outdoor(vit_int8=True, refiner_int8=True, config=TINY, device="cpu", amp=False,
                     coarse_res=56, upsample_res=64)
    from_jax_variables(variables, m.net)
    return m


def _images(seed, hw):
    return np.random.RandomState(seed).randn(1, hw, hw, 3).astype(np.float32) * 0.5


@pytest.mark.parametrize("upsample", [False, True], ids=["coarse", "upsample"])
def test_int8_matcher_matches_jax_per_scale(variables, upsample):
    """roma_outdoor(vit_int8=True, refiner_int8=True) at the tiny config
    through the JAX bridge against JAX's int8 RoMaNet, symmetric, every
    scale's flow and certainty; the int8 layers' flips counted over the pass."""
    m = _int8_matcher(variables)
    hw, sf = (64, 64 / 560) if upsample else (56, 0.1)
    a, b = _images(3, hw), _images(4, hw)
    kw = dict(symmetric=True, scale_factor=sf)
    if upsample:
        rs = np.random.RandomState(7)
        gy, gx = np.meshgrid(np.linspace(-1, 1, 56), np.linspace(-1, 1, 56), indexing="ij")
        flow = (np.stack([gx, gy], -1)[None].repeat(2, 0) * 0.9 + 0.03 * rs.randn(2, 56, 56, 2)).astype(np.float32)
        cert = rs.randn(2, 56, 56, 1).astype(np.float32)
        kw.update(upsample=True)
    tkw = dict(kw, **({"flow": torch.from_numpy(flow), "certainty": torch.from_numpy(cert)} if upsample else {}))
    jkw = dict(kw, **({"flow": jnp.asarray(flow), "certainty": jnp.asarray(cert)} if upsample else {}))
    port_in = _hold_to_jax(
        m.net, lambda: m.net(torch.from_numpy(a), torch.from_numpy(b), **tkw),
        lambda: JaxNet(config=JAX_INT8).apply(variables, jnp.asarray(a), jnp.asarray(b), **jkw),
        lambda out: {f"{k} at scale {s}": np.asarray(out[s][k]) for s in out for k in ("flow", "certainty")},
        "int8 matcher")
    # int8 products of a pass: 3 a ViT block in the coarse pass, then the 1x1s
    # of each stack wider than Kernel D's 32 channels, block1 and the hidden blocks
    wide = [s for s, spec in TINY.refiner_specs().items() if spec.hidden_dim > 32 and not (upsample and s == 16)]
    assert len(port_in) == (0 if upsample else 3 * TINY.dino_depth) + len(wide) * (1 + TINY.hidden_blocks)


def test_the_scale1_stack_stays_on_kernel_d(variables, monkeypatch):
    """An int8 model's scale-1 stack (C = 24) is not int8: it runs folded
    through fused_refiner_stack (Kernel D's wrapper) in inference, as the JAX
    package's fused path ignores int8; every wider stack's 1x1s are QConv1x1."""
    m = _int8_matcher(variables)
    for s, ref in m.net.decoder.conv_refiner.items():
        kinds = {type(b[3]) for b in (ref.block1, *ref.hidden_blocks)}
        assert kinds == ({torch.nn.Conv2d} if s == "1" else {QConv1x1}), s
    matcher_mod = importlib.import_module("roma_tpu_torch.models.matcher")
    widths = []
    real = matcher_mod.fused_refiner_stack
    monkeypatch.setattr(matcher_mod, "fused_refiner_stack", lambda d, blocks: widths.append(d.shape[-1]) or real(d, blocks))
    m.match(_images(1, 56)[0], _images(2, 56)[0])
    assert widths == [24, 24]  # scale 1 of the coarse and of the upsample pass


def test_training_mode_is_the_float_path_bit_for_bit():
    """refiner_int8 changes nothing in training: the QConv1x1s are the float
    convs there, as the JAX package's RefinerBlock(int8=True, train=True)."""
    a, b = (torch.from_numpy(_images(s, 56)) for s in (5, 6))
    outs = []
    for cfg in (TINY, dataclasses.replace(TINY, refiner_int8=True)):
        net = train_net(cfg, "cpu", seed=3)
        out = net(a, b, scale_factor=0.1)
        outs.append({(s, k): v for s, d in out.items() for k, v in d.items()})
        out[1]["flow"].sum().backward()
        outs.append({n: p.grad for n, p in net.named_parameters() if p.grad is not None})
    for got, ref in ((outs[2], outs[0]), (outs[3], outs[1])):
        assert got.keys() == ref.keys()
        assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_amp_keeps_the_int8_weights_float32():
    m = roma_outdoor(vit_int8=True, refiner_int8=True, config=TINY, device="cpu", coarse_res=56, upsample_res=64)
    q = [mod for mod in m.net.modules() if isinstance(mod, QConv1x1) or (isinstance(mod, QLinear) and mod.int8)]
    assert len(q) == 3 * TINY.dino_depth + 4 * (1 + TINY.hidden_blocks)
    assert {p.dtype for mod in q for p in mod.parameters()} == {torch.float32}
    assert m.net.encoder.dinov2.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    w, c = m.match(_images(1, 56)[0], _images(2, 56)[0])
    assert bool(torch.isfinite(w).all() and torch.isfinite(c).all())


def test_an_int8_variant_resolves_the_released_weights(monkeypatch):
    """The serving knobs are not the architecture: with the released
    architecture (here the tiny one) an int8 variant still fetches the
    released pair, loads it and writes it back through to_reference
    unchanged."""
    src = zoo.init_random(zoo.build_net(TINY, "cpu"), 5)
    roma_sd, dino_sd = zoo.convert.to_reference(src)
    fetched = []

    def fetch(url):
        fetched.append(url)
        return zoo.convert.state_dict_to_numpy(dino_sd if "dinov2" in url else roma_sd)

    monkeypatch.setattr(zoo, "RELEASED", TINY)
    monkeypatch.setattr(zoo, "_fetch_state_dict", fetch)
    m = roma_outdoor(vit_int8=True, refiner_int8=True, config=TINY, device="cpu", amp=False,
                     coarse_res=56, upsample_res=64)
    assert fetched == [zoo.WEIGHT_URLS["romatch"]["outdoor"], zoo.WEIGHT_URLS["dinov2"]]
    back_roma, back_dino = zoo.convert.to_reference(m.net)
    assert back_roma.keys() == roma_sd.keys() and back_dino.keys() == dino_sd.keys()
    assert all(torch.equal(back_roma[k], roma_sd[k]) for k in roma_sd)
    assert all(torch.equal(back_dino[k], dino_sd[k]) for k in dino_sd)


def test_int8_drift_tool_runs_at_a_small_size(capsys):
    from roma_tpu_torch.tools import int8_drift

    report = int8_drift.main(["--device", "cpu", "--res", "56", "--dim", "32", "--depth", "2", "--heads", "2",
                              "--refiner_c", "40", "--refiner_hw", "9"])
    out = capsys.readouterr().out
    assert "DINOv2" in out and "refiner block" in out
    for r in report.values():
        assert 0.9 < r["corr"] <= 1.0 and 0 < r["rms_d_over_rms"] < 0.1 and r["max_d_over_rms"] > 0
