"""Kernel N (ops/depthwise.py, csrc/depthwise.cu) and the wide refiner stack
it runs in (ops.wide_stack, ConvRefiner's route at widths above Kernel D's).

On the CPU: N's plain version against the module chain (depthwise conv,
eval BatchNorm, ReLU) at the released widths, in its padded form too;
ConvRefiner's inference output on the new route against the module chain,
and the whole match (both passes) against it; the routing (nine calls a
wide stack of the released depth, none in training, none for an int8
stack); N's argument checks and the kept padded operands. The tests marked
``card`` hold N to its plain version at every wide shape of the 560 -> 864
and 672 -> 1344 matches, show that a planted fault breaks that bar, and
count N's launches in a request, an engine batch and a training forward;
they skip without a CUDA device and run on the card with

    python3 -m pytest tests/test_torch_wide_depthwise.py -m card
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from roma_tpu_torch import RoMaConfig, roma_outdoor
from roma_tpu_torch.models.blocks import nhwc
from roma_tpu_torch.models.config import RefinerSpec
from roma_tpu_torch.models.matcher import ConvRefiner
from roma_tpu_torch.ops import depthwise as dwmod
from roma_tpu_torch.ops import fold_refiner
from roma_tpu_torch.ops.depthwise import (
    C_ALIGN,
    depthwise_bn_relu,
    depthwise_bn_relu_reference,
    depthwise_checks,
    padded_block,
    padded_width,
    wide_stack,
)
from roma_tpu_torch.tools.bench_hcw_refiner import make_modules
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

# the wide stacks' widths at released dims: scales 16, 8, 4, 2
WIDTHS = (1377, 1137, 569, 144)
# the refiner specs of those scales (in = hidden = C)
SPECS = {1377: (128, 7, 512), 1137: (64, 3, 512), 569: (32, 2, 256), 144: (16, None, 64)}


def modules(c, n=9, seed=0, device="cpu", dtype=torch.float32):
    return make_modules(c, torch.Generator(device=device).manual_seed(seed), device, n=n, dtype=dtype)


def refiner(c, seed=0, int8=False) -> ConvRefiner:
    """A ConvRefiner of the released scale of width ``c``, eval mode, its
    blocks on make_modules' seeded spread (activations of order one)."""
    emb, r, _ = SPECS[c]
    m = ConvRefiner(RefinerSpec(in_dim=c, hidden_dim=c, disp_emb_dim=emb, local_corr_radius=r), int8=int8)
    with torch.no_grad():
        for dst, src in zip((m.block1, *m.hidden_blocks), modules(c, seed=seed)):
            dst.load_state_dict(src.state_dict())
    return m.eval()


def refiner_inputs(c, h=9, w=11, seed=0):
    g = torch.Generator().manual_seed(seed)
    proj = SPECS[c][2]
    return (torch.randn(2, h, w, proj, generator=g), torch.randn(2, h, w, proj, generator=g),
            torch.rand(2, h, w, 2, generator=g) * 2 - 1)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", WIDTHS)
def test_plain_version_equals_the_module_chain(c):
    """depthwise conv -> eval BatchNorm -> ReLU, as modules, against N's
    plain version on the folded weights, float32, odd sides; and the padded
    form, whose first C channels are the same and whose padding stays 0."""
    mods = modules(c, n=1)
    blk = fold_refiner(mods[0], [])[0]
    x = torch.randn(2, 7, 9, c, generator=torch.Generator().manual_seed(c))
    with torch.no_grad():
        want = nhwc(mods[0][:3], x)
    got = depthwise_bn_relu(x, blk["dw"], blk["db"])
    assert got.shape == want.shape and got.dtype == x.dtype
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    cp = padded_width(c)
    assert cp % C_ALIGN == 0 and 0 <= cp - c < C_ALIGN
    p = padded_block(blk, cp, torch.float32)
    xp = torch.nn.functional.pad(x, (0, cp - c))
    padded = depthwise_bn_relu(xp, p["dw"], p["db"])
    torch.testing.assert_close(padded[..., :c], got, atol=1e-6, rtol=1e-6)
    assert bool((padded[..., c:] == 0).all())


def test_padded_widths():
    assert [padded_width(c) for c in WIDTHS] == [1384, 1144, 576, 144]
    assert [padded_width(c) for c in (1, 8, 9, 24, 89)] == [8, 8, 16, 24, 96]


def test_plain_version_rounds_once_to_the_io_dtype():
    """In bf16 the plain version is the f32 result rounded once."""
    blk = fold_refiner(modules(144, n=1)[0], [])[0]
    x = torch.randn(1, 6, 5, 144, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    got = depthwise_bn_relu_reference(x, blk["dw"], blk["db"])
    f32 = depthwise_bn_relu_reference(x.float(), blk["dw"], blk["db"])
    assert got.dtype == torch.bfloat16 and torch.equal(got, f32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the wide stack and ConvRefiner's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", WIDTHS)
def test_refiner_on_the_new_route_equals_the_module_chain(c, monkeypatch):
    """ConvRefiner's inference output, float32: Kernel N's plain version and
    the GEMM on the padded channels against the blocks as modules."""
    m = refiner(c)
    x, y, flow = refiner_inputs(c)
    calls = count_calls(monkeypatch)
    with torch.no_grad():
        got = m(x, y, flow, scale_factor=1.5)
        assert calls["n"] == 9
        monkeypatch.setattr(ConvRefiner, "_on_wide_stack", lambda self: False)
        want = m(x, y, flow, scale_factor=1.5)
    assert calls["n"] == 9
    for g, w in zip(got, want):
        assert w.abs().max() > 0.1  # activations of order one reach the output
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_wide_stack_works_in_place_and_keeps_the_padding_zero():
    c = 89
    mods = modules(c, n=3)
    blocks = [padded_block(b, padded_width(c), torch.float32) for b in fold_refiner(mods[0], mods[1:])]
    x = torch.randn(1, 5, 6, c, generator=torch.Generator().manual_seed(3))
    xp = torch.nn.functional.pad(x, (0, padded_width(c) - c))
    out = wide_stack(xp, blocks)
    assert out is xp  # each block's output over its input: a stack holds two maps
    assert out.shape == (1, 5, 6, 96) and bool((out[..., c:] == 0).all())
    with torch.no_grad():
        want = x
        for mod in mods:
            want = nhwc(mod, want)
    torch.testing.assert_close(out[..., :c], want, atol=1e-5, rtol=1e-5)


def test_match_on_the_new_route_equals_the_module_chain(monkeypatch):
    """The whole match, coarse and upsample passes, float32 at the tiny
    config (wide stacks of 89, 65, 49 and 40 channels, padded to 96, 72, 56
    and 40): warp and certainty against the blocks as modules."""
    m = roma_outdoor(device="cpu", amp=False, coarse_res=56, upsample_res=64, config=RoMaConfig.tiny())
    with torch.no_grad():
        for name, mod in m.net.named_modules():
            if isinstance(mod, torch.nn.BatchNorm2d) and "conv_refiner" in name:
                g = torch.Generator().manual_seed(len(name))
                mod.running_mean.copy_(0.05 * torch.randn(mod.num_features, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.num_features, generator=g))
    rs = np.random.RandomState(0)
    im_a, im_b = (rs.randn(56, 56, 3).astype(np.float32) for _ in range(2))
    calls = count_calls(monkeypatch)
    warp, cert = m.match(im_a, im_b)
    assert calls["n"] == 4 * 3 + 3 * 3  # scales 16-2, then 8-2, three blocks a stack
    monkeypatch.setattr(ConvRefiner, "_on_wide_stack", lambda self: False)
    want_warp, want_cert = m.match(im_a, im_b)
    assert calls["n"] == 21
    torch.testing.assert_close(warp, want_warp, atol=1e-5, rtol=0)
    torch.testing.assert_close(cert, want_cert, atol=1e-5, rtol=0)


def count_calls(monkeypatch) -> dict:
    """Count wide_stack's calls of Kernel N's wrapper (on the CPU its
    ``launches`` counter stays put)."""
    calls = {"n": 0}
    inner = dwmod.depthwise_bn_relu

    def counted(*a):
        calls["n"] += 1
        return inner(*a)

    monkeypatch.setattr(dwmod, "depthwise_bn_relu", counted)
    return calls


def test_routing_training_and_int8_and_scale_one_keep_their_paths(monkeypatch):
    calls = count_calls(monkeypatch)
    x, y, flow = refiner_inputs(144)
    m = refiner(144).train()
    m(x, y, flow)[0].sum().backward()  # training: the modules, batch statistics
    assert calls["n"] == 0
    q = refiner(144, int8=True)
    with torch.no_grad():
        q(x, y, flow)
    assert calls["n"] == 0 and not q._on_wide_stack()
    narrow = ConvRefiner(RefinerSpec(in_dim=24, hidden_dim=24, disp_emb_dim=6)).eval()
    with torch.no_grad():
        narrow(x[..., :9], y[..., :9], flow)
    assert calls["n"] == 0 and not narrow._on_wide_stack()
    with torch.no_grad():
        m.eval()(x, y, flow)
    assert calls["n"] == 9


# ---------------------------------------------------------------------------
# argument checks and the kept operands
# ---------------------------------------------------------------------------

def _args(c=16, dtype=torch.bfloat16):
    return torch.zeros(1, 3, 4, c, dtype=dtype), torch.zeros(5, 5, c), torch.zeros(c)


def test_checks_accept_the_contract():
    x, dw, db = _args()
    assert depthwise_checks("t", x, dw, db) == (1, 3, 4, 16)
    assert depthwise_checks("t", x.float(), dw, db) == (1, 3, 4, 16)


@pytest.mark.parametrize("case", ["dtype", "c_align", "dw_shape", "dw_dtype", "db_shape", "strided", "misaligned",
                                  "no_rows"])
def test_checks_refuse(case):
    x, dw, db = _args()
    err = ValueError
    if case == "dtype":
        x, err = x.half(), TypeError
    elif case == "c_align":
        x, dw, db = _args(12)
    elif case == "dw_shape":
        dw = torch.zeros(3, 3, 16)
    elif case == "dw_dtype":
        dw = dw.double()
    elif case == "db_shape":
        db = torch.zeros(8)
    elif case == "strided":
        x = torch.zeros(1, 4, 3, 16, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "misaligned":
        x = torch.zeros(1 * 3 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 3, 4, 16)
    elif case == "no_rows":
        x = torch.zeros(1, 0, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(err):
        depthwise_checks("t", x, dw, db)


def test_checks_refuse_a_gradient_and_the_wrapper_a_foreign_device():
    x, dw, db = _args(dtype=torch.float32)
    with pytest.raises(RuntimeError):
        depthwise_checks("t", x.requires_grad_(), dw, db)
    with pytest.raises(ValueError):
        depthwise_bn_relu(torch.zeros(1, 3, 4, 16, device="meta"), dw, db)


def test_padded_operands():
    blk = fold_refiner(modules(9, n=1)[0], [])[0]
    p = padded_block(blk, 16, torch.bfloat16)
    assert p["w2"].dtype == p["b2"].dtype == torch.bfloat16 and p["dw"].dtype == p["db"].dtype == torch.float32
    assert tuple(p["dw"].shape) == (5, 5, 16) and tuple(p["w2"].shape) == (16, 16) and p["dw"].is_contiguous()
    assert torch.equal(p["w2"][:9, :9], blk["w2"].to(torch.bfloat16)) and not p["w2"][9:].any() and not p["w2"][:, 9:].any()
    assert torch.equal(p["dw"][..., :9], blk["dw"]) and not p["dw"][..., 9:].any() and not p["b2"][9:].any()


def test_refiner_keeps_its_padded_blocks_until_a_source_or_the_dtype_changes():
    """The wide stack's operands are folded once a dtype and kept without
    their float32 C x C folds; a write to a parameter refolds them."""
    m = refiner(144)
    blocks = m.folded_blocks(torch.bfloat16)
    assert m.folded_blocks(torch.bfloat16) is blocks and len(blocks) == 9
    assert all(set(b) == {"dw", "db", "w2", "b2"} and b["w2"].dtype == torch.bfloat16 for b in blocks)
    f32 = m.folded_blocks(torch.float32)
    assert f32 is not blocks and f32[0]["w2"].dtype == torch.float32
    with torch.no_grad():
        m.hidden_blocks[0][3].weight.mul_(2)
    again = m.folded_blocks(torch.float32)
    assert again is not f32 and torch.equal(again[1]["w2"], 2 * f32[1]["w2"])
    torch.testing.assert_close(again[0]["w2"], f32[0]["w2"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's conv in full float32
    return torch.device("cuda")


# the wide stacks' maps, (side, C): the 560 -> 864 match's and the 672 -> 1344 one's
SHAPES = {
    "560to864": ((35, 1377), (70, 1137), (140, 569), (280, 144), (108, 1137), (216, 569), (432, 144)),
    "672to1344": ((42, 1377), (84, 1137), (168, 569), (336, 144), (168, 1137), (336, 569), (672, 144)),
}
BATCHES = {"560to864": (2, 16), "672to1344": (2, 8)}  # decoder batches: one pair, an engine batch
CARD_CASES = [(cfg, b, dt) for cfg in SHAPES for b in BATCHES[cfg] for dt in ("bf16", "f32")]


def bar_excess(got, want, dtype) -> float:
    """How far ``got`` lies past the bar, <= 0 within it: in bf16 one ulp of
    each element of ``want`` (the plain version in f32, rounded), and where
    the 25 taps cancel to near zero, the f32 sums' own rounding, which moves
    with the order of the sum: 2^-16 of ``want``'s largest magnitude (1/512
    of its ulp); in f32 1e-5 of ``want``'s largest magnitude."""
    got, want = got.float(), want.float()
    err, top = (got - want).abs(), want.abs().max()
    if dtype == torch.bfloat16:
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
        return (err - torch.maximum(ulp, 2.0**-16 * top)).max().item()
    return (err.max() - 1e-5 * top).item()


def tap_dropped(x, dw, db):
    """The plain version with one planted fault: the centre tap's weight
    left out."""
    dw = dw.clone()
    dw[2, 2] = 0
    return depthwise_bn_relu_reference(x, dw, db)


@pytest.mark.card
@pytest.mark.parametrize("cfg,batch,dt", CARD_CASES, ids=[f"{c}-b{b}-{d}" for c, b, d in CARD_CASES])
def test_kernel_equals_the_plain_version_on_the_card(cfg, batch, dt):
    dev = _card()
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    g = torch.Generator(device=dev).manual_seed(batch)
    before = depthwise_bn_relu.launches
    for side, c in SHAPES[cfg]:
        blk = fold_refiner(make_modules(c, g, dev, n=1)[0], [])[0]
        cp = padded_width(c)
        p = padded_block(blk, cp, dtype)
        x = torch.nn.functional.pad(torch.randn(batch, side, side, c, generator=g, device=dev), (0, cp - c))
        x = x.to(dtype)
        got = depthwise_bn_relu(x, p["dw"], p["db"])
        want = depthwise_bn_relu_reference(x.float(), p["dw"], p["db"]).to(dtype)
        excess = bar_excess(got, want, dtype)
        assert excess <= 0, f"{cfg} batch {batch} {dt} {side}^2 C{c}: {excess} past the bar"
        assert bool((got[..., c:] == 0).all())
        fault = bar_excess(tap_dropped(x.float(), p["dw"], p["db"]).to(dtype), want, dtype)
        assert fault > 0, f"{cfg} {side}^2 C{c}: a dropped tap would pass the bar"
        del x, got, want
    assert depthwise_bn_relu.launches - before == len(SHAPES[cfg])


@pytest.mark.card
def test_kernel_at_ragged_edges_on_the_card():
    """Sides of 1 to 19 pixels, channels 8 to 200 (a partial channel group
    above 160), batch 3: the halo's zero fill and the tile edges."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    for h, w, c in ((1, 1, 8), (3, 19, 16), (17, 2, 40), (9, 13, 152), (11, 10, 168), (19, 7, 200)):
        blk = fold_refiner(make_modules(c, g, dev, n=1)[0], [])[0]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(3, h, w, c, generator=g, device=dev).to(dtype)
            got = depthwise_bn_relu(x, blk["dw"], blk["db"])
            want = depthwise_bn_relu_reference(x.float(), blk["dw"], blk["db"]).to(dtype)
            assert bar_excess(got, want, dtype) <= 0, f"{h}x{w} C{c} {dtype}"


@pytest.mark.card
def test_launches_a_request_an_engine_batch_and_a_training_forward(tmp_path):
    """63 launches a single-pair request and an engine batch at 560 -> 864
    (the coarse pass's 4 wide stacks of 9 blocks, the upsample pass's 3),
    none in a training forward."""
    from roma_tpu_torch.serving import MatchEngine

    dev = _card()
    m = roma_outdoor(device="cuda", seed=0)
    rs = np.random.RandomState(0)
    ims = [(rs.rand(600, 800, 3) * 255).astype(np.uint8) for _ in range(4)]
    from PIL import Image

    pil = [Image.fromarray(a) for a in ims]
    before = depthwise_bn_relu.launches
    m.match(pil[0], pil[1])
    torch.cuda.synchronize()
    assert depthwise_bn_relu.launches - before == 63
    paths = []
    for i, im in enumerate(pil):
        paths.append(str(tmp_path / f"{i}.png"))
        im.save(paths[-1])
    before = depthwise_bn_relu.launches
    results = list(MatchEngine(m, batch_size=2).match_paths([tuple(paths[:2]), tuple(paths[2:])]))
    torch.cuda.synchronize()
    assert len(results) == 2 and depthwise_bn_relu.launches - before == 63
    del m
    torch.cuda.empty_cache()
    r = refiner(144).to(dev).train()
    x, y, flow = (t.to(dev) for t in refiner_inputs(144))
    before = depthwise_bn_relu.launches
    r(x, y, flow)[0].sum().backward()
    torch.cuda.synchronize()
    assert depthwise_bn_relu.launches == before
