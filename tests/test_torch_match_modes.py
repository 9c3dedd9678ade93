"""The port's matcher modes against the JAX matcher (counterpart of
tests/test_match_modes.py) at RoMaConfig.tiny(), float32 on the CPU, with
the same weights on both sides: {symmetric} x {upsample_preds} x {tensor
bs1, tensor bs2, PIL, path}, attenuate_cert=False, match(batched=False),
get_output_resolution, coarse_dtype, and the four sample modes."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from roma_tpu.models.roma import RegressionMatcher as JaxMatcher
from roma_tpu_torch.models.roma import RegressionMatcher
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

ATOL = 2e-3  # the bar of tests/test_roma_parity.py:427-437, as tests/test_torch_roma.py
H = W = 56
UP = (64, 64)
INPUTS = ("tensor bs1", "tensor bs2", "pil", "path")
DEFAULTS = dict(symmetric=True, upsample_preds=True, attenuate_cert=True,
                sample_mode="threshold_balanced", sample_thresh=0.05)


@pytest.fixture(scope="module")
def nets():
    variables = seeded_tiny_variables(0)
    return variables, port_net(variables), {}


@pytest.fixture(scope="module")
def image_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    paths = []
    for name in ("a", "b"):
        p = d / f"{name}.png"
        Image.fromarray((rs.rand(80, 100, 3) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


def _matchers(nets, **kw):
    """(JAX matcher, port matcher) with the same arguments; the JAX ones are
    kept, since each instance compiles its own programs."""
    variables, net, cache = nets
    key = tuple(sorted({**DEFAULTS, **kw}.items()))
    if key not in cache:
        cache[key] = JaxMatcher(variables, h=H, w=W, upsample_res=UP, config=TINY, **kw)
    return cache[key], RegressionMatcher(net, h=H, w=W, upsample_res=UP, **kw)


def _inputs(kind, image_paths):
    """(JAX inputs, port inputs, batch size or None for an unbatched pair)."""
    if kind == "path":
        return image_paths, image_paths, None
    if kind == "pil":
        pils = [Image.open(p) for p in image_paths]
        return pils, pils, None
    bs = int(kind[-1])
    rs = np.random.RandomState(bs)
    arrs = [(0.5 * rs.randn(bs, H, W, 3)).astype(np.float32) for _ in range(2)]
    return arrs, [torch.from_numpy(a) for a in arrs], bs


def _compare(jout, tout):
    (jw, jc), (tw, tc) = jout, tout
    assert tuple(tw.shape) == np.shape(jw) and tuple(tc.shape) == np.shape(jc)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, err_msg="warp")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, err_msg="certainty")


CASES = [(dict(symmetric=s, upsample_preds=u), kind, {})
         for s in (False, True) for u in (False, True) for kind in INPUTS]
CASES += [(dict(attenuate_cert=False), "tensor bs2", {}),
          (dict(symmetric=False, upsample_preds=False, attenuate_cert=False), "tensor bs1", {}),
          (dict(), "tensor bs2", dict(batched=False)),
          (dict(symmetric=False), "tensor bs2", dict(batched=False))]


def _case_id(kw, kind, call):
    return "-".join([*(f"{k}={int(v)}" for k, v in kw.items()), kind.replace(" ", "_"),
                     *(f"{k}={int(v)}" for k, v in call.items())])


@pytest.mark.parametrize("kw,kind,call", CASES, ids=[_case_id(*c) for c in CASES])
def test_match_modes_match_jax(nets, image_paths, kw, kind, call):
    jm, tm = _matchers(nets, **kw)
    ja, ta, bs = _inputs(kind, image_paths)
    jout, tout = jm.match(*ja, **call), tm.match(*ta, **call)
    _compare(jout, tout)
    oh, ow = tm.get_output_resolution()
    ow *= 2 if tm.symmetric else 1
    lead = () if bs is None or call.get("batched") is False else (bs,)
    assert tuple(tout[0].shape) == (*lead, oh, ow, 4) and tuple(tout[1].shape) == (*lead, oh, ow)
    assert tout[0].abs().max() <= 1


@pytest.mark.parametrize("upsample", [False, True])
def test_get_output_resolution(nets, upsample):
    jm, tm = _matchers(nets, upsample_preds=upsample)
    assert tm.get_output_resolution() == tuple(jm.get_output_resolution()) == (UP if upsample else (H, W))


def test_coarse_dtype_runs_dinov2_in_it(nets):
    """coarse_dtype=float32 on a float32 net changes nothing; bfloat16 casts
    DINOv2 alone, and the match stays within the JAX matcher's own
    coarse_dtype=bfloat16 result at the parity bar."""
    variables, net, _ = nets
    ja, ta, _ = _inputs("tensor bs1", None)
    same = RegressionMatcher(port_net(variables), h=H, w=W, upsample_res=UP, coarse_dtype=torch.float32)
    ref = RegressionMatcher(net, h=H, w=W, upsample_res=UP).match(*ta)
    assert all(torch.equal(g, r) for g, r in zip(same.match(*ta), ref))

    tm = RegressionMatcher(port_net(variables), h=H, w=W, upsample_res=UP, coarse_dtype=torch.bfloat16)
    enc = tm.net.encoder
    assert {p.dtype for p in enc.dinov2.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in enc.cnn.parameters()} == {torch.float32} and tm.dtype == torch.float32
    jm = JaxMatcher(variables, h=H, w=W, upsample_res=UP, config=TINY, coarse_dtype=jnp.bfloat16)
    _compare(jm.match(*ja), tm.match(*ta))


MODES = ("threshold_balanced", "threshold", "balanced", "random")


@pytest.mark.parametrize("mode", MODES)
def test_sample_modes_pick_what_jax_picks(nets, mode):
    """Inputs whose selection does not depend on the generator: without
    "balanced", certainty is non-zero on exactly ``num`` of 4 * num rows, so
    the draw is those rows; with it, there are ``num`` rows, so both draws
    take them all. Either way the returned certainties show whether the
    threshold (0.3 here) saturated them."""
    num, thresh = 24, 0.3
    n = num if "balanced" in mode else 4 * num
    rs = np.random.RandomState(5)
    matches = rs.uniform(-1, 1, (n, 4)).astype(np.float32)
    cert = np.zeros(n, np.float32)
    live = rs.permutation(n)[:num]
    cert[live] = rs.choice([0.01, 0.2, 0.5, 0.9], num)
    if "balanced" in mode:
        cert[live[:3]] = 0.0  # zero certainty is still drawn when every row is
    jm, tm = _matchers(nets, sample_mode=mode, sample_thresh=thresh)
    jmatch, jcert = jm.sample(matches, cert, num=num, key=jax.random.PRNGKey(0))
    tmatch, tcert = tm.sample(torch.from_numpy(matches), torch.from_numpy(cert), num=num, key=0)
    assert tuple(tmatch.shape) == (num, 4) and tuple(tcert.shape) == (num,)

    def rows(m, c):
        return sorted(map(tuple, np.concatenate([np.asarray(m), np.asarray(c)[:, None]], 1).tolist()))

    assert rows(tmatch.numpy(), tcert.numpy()) == rows(jmatch, jcert)
    t = tcert.numpy()
    above = (t > thresh) & (t < 1)
    if "threshold" in mode:
        assert (t == 1).any() and not above.any()
    else:
        assert above.any() and not (t == 1).any()
