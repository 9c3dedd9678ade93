"""Kernel M (ops/resize.py, csrc/resize.cu): Pillow's bicubic resize fused
with the ImageNet normalization.

On the CPU the plain path is held to the installed Pillow bit for bit over
a sweep of shapes and contents. That sweep is also the guard of the
matcher's prep: ``RegressionMatcher.match`` resizes with M (its plain path
on the CPU) in place of PIL, so a Pillow whose coefficients or rounding
differ from ``pillow_coeffs`` fails here, and the prep must not ship until
the model follows it. The tests
marked ``card`` hold M to the plain path on the card, the matcher's inputs
to the PIL path's, and unsynchronized calls to synchronized ones; they skip
without a CUDA device and run on the card with

    python3 -m pytest tests/test_torch_resize.py -m card
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from roma_tpu_torch.ops import KERNEL_WRAPPERS
from roma_tpu_torch.ops.resize import (
    SMEM_BYTES,
    pillow_coeffs,
    resize_normalize,
    resize_normalize_reference,
    resize_plan,
    resize_u8_reference,
)
from roma_tpu_torch.utils.image import imagenet_normalize, resize
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

# (H, W) -> (h, w): the single-pair traffic's canvases, the engine's input
# sizes, up- and downsampling on each axis, odd and non-square sizes, sides
# of one pixel, one axis unchanged, both unchanged
SWEEP = [
    ((720, 960), (560, 560)), ((720, 960), (864, 864)),
    ((900, 1200), (560, 560)), ((900, 1200), (864, 864)),
    ((1200, 1600), (560, 560)), ((1200, 1600), (864, 864)),
    ((37, 53), (29, 101)), ((37, 53), (90, 20)), ((64, 48), (101, 97)),
    ((1, 1), (5, 7)), ((5, 7), (1, 1)), ((1, 40), (3, 1)), ((40, 1), (1, 9)),
    ((37, 53), (37, 20)), ((37, 53), (90, 53)), ((37, 53), (37, 53)),
]
SIZES = [f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in SWEEP]
CONTENTS = ("noise", "saturated")


def image(hw, content: str, seed: int = 0) -> np.ndarray:
    """(H, W, 3) uint8: uniform noise, or a field of 0 and 255 in blocks
    (each tap's overshoot drives the sums past both ends of clip8)."""
    rs = np.random.RandomState(seed)
    if content == "noise":
        return rs.randint(0, 256, (*hw, 3)).astype(np.uint8)
    blocks = rs.randint(0, 2, ((hw[0] + 2) // 3, (hw[1] + 2) // 3, 3)).astype(np.uint8) * 255
    return np.ascontiguousarray(blocks.repeat(3, 0).repeat(3, 1)[: hw[0], : hw[1]])


def pil_bytes(x: np.ndarray, hw) -> np.ndarray:
    return np.asarray(Image.fromarray(x).resize((hw[1], hw[0]), Image.BICUBIC))


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("sizes", SWEEP, ids=SIZES)
def test_plain_path_gives_pillows_bytes(sizes, content):
    (hw_in, hw_out) = sizes
    x = image(hw_in, content)
    got = resize_u8_reference(torch.from_numpy(x)[None], hw_out)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, *hw_out, 3)
    np.testing.assert_array_equal(got[0].numpy(), pil_bytes(x, hw_out))


def test_coefficients_follow_pillow_at_random_sizes():
    """One axis at a time, 60 random (in, out) sizes from 1 to 700 in both
    directions: the coefficient model against Pillow on single-row images
    (a miss in a table shows as a wrong byte)."""
    rs = np.random.RandomState(7)
    for _ in range(60):
        n_in, n_out = rs.randint(1, 701, 2)
        x = image((1, n_in), "noise", seed=int(n_in))
        for hw_in, hw_out, xi in (((1, n_in), (1, n_out), x), ((n_in, 1), (n_out, 1), x.transpose(1, 0, 2))):
            xi = np.ascontiguousarray(xi)
            got = resize_u8_reference(torch.from_numpy(xi)[None], hw_out)[0].numpy()
            np.testing.assert_array_equal(got, pil_bytes(xi, hw_out), err_msg=f"{hw_in} -> {hw_out}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_float_ops_are_the_pil_paths(dtype):
    """The plain path's output equals today's ops on PIL's bytes,
    ``imagenet_normalize(x.float() / 255.0).to(dtype)``, bit for bit, for a
    batch of two images of the traffic's size."""
    x = np.stack([image((720, 960), "noise", seed=s) for s in (1, 2)])
    for hw in ((560, 560), (864, 864)):
        got = resize_normalize(torch.from_numpy(x), hw, dtype)
        u8 = torch.from_numpy(np.stack([pil_bytes(im, hw) for im in x]))
        want = imagenet_normalize(u8.float() / 255.0).to(dtype)
        assert got.dtype == dtype and got.is_contiguous()
        assert torch.equal(got, want)


def test_argument_checks():
    x = torch.zeros((1, 9, 11, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        resize_normalize(x.float(), (5, 5), torch.float32)
    with pytest.raises(TypeError, match="not supported"):
        resize_normalize(x, (5, 5), torch.float16)
    with pytest.raises(ValueError, match="RGB"):
        resize_normalize(x[0], (5, 5), torch.float32)
    with pytest.raises(ValueError, match="RGB"):
        resize_normalize(torch.zeros((1, 9, 11, 4), dtype=torch.uint8), (5, 5), torch.float32)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        resize_normalize(torch.zeros((1, 9, 11, 3), dtype=torch.uint8, device="meta"), (5, 5), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        resize_normalize(torch.zeros((1, 11, 9, 3), dtype=torch.uint8).transpose(1, 2), (5, 5), torch.float32)
    with pytest.raises(ValueError, match=">= 1"):
        resize_normalize(x, (0, 5), torch.float32)
    assert all(f.launches == 0 for f in KERNEL_WRAPPERS)  # the CPU never launches


def test_tables_and_plans():
    """The identity where a size is kept; weights summing to 1 << 22 within
    rounding; tiles whose intermediate fits the block, shrinking for a steep
    downscale and refused past what a block holds; warm calls cached."""
    ident = pillow_coeffs(37, 37)
    assert ident.shape == (37, 3) and (ident[:, 0] == np.arange(37)).all() and (ident[:, 2] == 1 << 22).all()
    tab = pillow_coeffs(960, 560)
    assert tab.dtype == np.int32 and not tab.flags.writeable
    assert (abs(tab[:, 2:].sum(1) - (1 << 22)) <= tab[:, 1]).all()
    assert pillow_coeffs(960, 560) is tab
    assert resize_plan(720, 560, 560)[:2] == (16, 64)
    for in_h, out_h in ((720, 560), (1200, 864), (20000, 7), (3, 900)):
        rows, cols, span = resize_plan(in_h, out_h, 100)
        assert span * cols * 3 <= SMEM_BYTES
    assert resize_plan(20000, 7, 100)[:2] != (16, 64)
    with pytest.raises(ValueError, match="downscale"):
        resize_plan(10_000_000, 1, 1)


def pil_path(a: Image.Image, b: Image.Image, hw, dtype, device) -> tuple:
    """Both images through PIL's bicubic resize on the host, then the [0, 1]
    scaling and the ImageNet normalization on ``device``."""
    return tuple(imagenet_normalize(torch.from_numpy(np.array(resize(p, hw)))[None].to(device).float() / 255.0)
                 .to(dtype) for p in (a, b))


def test_cpu_matcher_keeps_pil(monkeypatch):
    """On the CPU the matcher's prep goes through ``resize_normalize`` (its
    plain version), once a size for a pair of one size, and gives the PIL
    path's values bit for bit."""
    from roma_tpu_torch.models import roma as roma_mod
    from roma_tpu_torch.models.config import RoMaConfig
    from roma_tpu_torch.models.zoo import roma_outdoor

    m = roma_outdoor(config=RoMaConfig.tiny(), amp=False, coarse_res=56, upsample_res=64, device="cpu")
    calls = []
    monkeypatch.setattr(roma_mod, "resize_normalize", lambda *a: calls.append(a[1]) or resize_normalize(*a))
    a, b = (Image.fromarray(image((40, 50), "noise", seed=s)) for s in (3, 4))
    got = m._prep_pair(a, b, [(56, 56), (64, 64)])
    assert calls == [(56, 56), (64, 64)]
    for (im_a, im_b), hw in zip(got, ((56, 56), (64, 64))):
        want = pil_path(a, b, hw, m.dtype, "cpu")
        assert torch.equal(im_a, want[0]) and torch.equal(im_b, want[1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_equals_the_plain_path_on_the_card(dtype):
    dev = _card()
    before = resize_normalize.launches
    for i, (hw_in, hw_out) in enumerate(SWEEP):
        for content in CONTENTS:
            x = torch.from_numpy(np.stack([image(hw_in, content, seed=s) for s in (i, i + 100)])).to(dev)
            got = resize_normalize(x, hw_out, dtype)
            want = resize_normalize_reference(x, hw_out, dtype)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (hw_in, hw_out, content)
            u8 = torch.from_numpy(np.stack([pil_bytes(im, hw_out) for im in x.cpu().numpy()])).to(dev)
            assert torch.equal(got, imagenet_normalize(u8.float() / 255.0).to(dtype)), (hw_in, hw_out, content)
    assert resize_normalize.launches - before == 2 * len(SWEEP)


def _matcher(amp: bool):
    from roma_tpu_torch.models.config import RoMaConfig
    from roma_tpu_torch.models.zoo import roma_outdoor

    return roma_outdoor(config=RoMaConfig.tiny(), amp=amp, device="cuda")


def _pool(n: int):
    from perfbench.lib.traffic import sub_seed, synthetic_pair

    return [synthetic_pair(sub_seed(3_000_000_019, 1, i), (720, 960)) for i in range(n)]


@pytest.mark.card
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_match_inputs_equal_the_pil_path_on_the_card(amp):
    """``_prep_inputs`` on the single-pair pool's PIL pairs (and on a pair of
    two sizes) against the PIL path: PIL's resize, the same torch ops on the
    card. Two launches a pair of one size, four for two sizes."""
    _card()
    m = _matcher(amp)
    assert m.dtype == (torch.bfloat16 if amp else torch.float32)
    pairs = _pool(4) + [(Image.fromarray(image((900, 1200), "noise", 5)), Image.fromarray(image((720, 961), "noise", 6)))]
    for k, (a, b) in enumerate(pairs):
        before = resize_normalize.launches
        im_a, im_b, up_a, up_b, _ = m._prep_inputs(a, b, None, None)
        assert resize_normalize.launches - before == (2 if a.size == b.size else 4)
        for got, hw in (((im_a, im_b), (560, 560)), ((up_a, up_b), (864, 864))):
            want = pil_path(a, b, hw, m.dtype, m.device)
            assert all(g.dtype == m.dtype and torch.equal(g, w) for g, w in zip(got, want)), (k, hw)


@pytest.mark.card
def test_unsynchronized_matches_equal_synchronized_ones():
    """Inputs prepared, and matches issued, back to back behind a busy card
    with no synchronization between them, equal the same calls each
    synchronized: the staging buffer is not rewritten under a copy still in
    flight. The prepared inputs show a rewrite directly (their preparation
    never waits for the card); the warps show it wherever the match does
    not wait for the card itself."""
    _card()
    m = _matcher(True)
    pairs = _pool(4)
    synced_inputs, synced = [], []
    for a, b in pairs:
        synced_inputs.append(m._prep_inputs(a, b, None, None)[:4])
        torch.cuda.synchronize()
        synced.append(m.match(a, b))
        torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # the card busy: each resize below waits behind it, its copy does not
    loose_inputs = [m._prep_inputs(a, b, None, None)[:4] for a, b in pairs]
    torch.cuda._sleep(1_000_000_000)
    loose = [m.match(a, b) for a, b in pairs]
    torch.cuda.synchronize()
    for k, (want, got) in enumerate(zip(synced_inputs, loose_inputs)):
        assert all(torch.equal(w, g) for w, g in zip(want, got)), k
    for (w0, c0), (w1, c1) in zip(synced, loose):
        assert torch.equal(w0, w1) and torch.equal(c0, c1)
