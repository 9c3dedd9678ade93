"""The port's ``balanced_sample`` against the JAX package's on identical
uniforms, on the CPU.

JAX draws its Gumbel noise as ``-log(-log(u))`` with ``u`` from
``jax.random.uniform(k, shape, minval=finfo(float32).tiny, maxval=1)``,
``k`` the key (the two halves of ``jax.random.split(key)`` in the balanced
modes: the certainty draw, then the inverse-density draw). The test computes
those uniforms with JAX and hands them to the port in place of
``torch.rand``, so the two implementations see the same random numbers and
must give the same draws. The warp is the ground truth of the capstone's
scene 0 (``tools/crossimpl``) at 160 x 224, its certainty a seeded sigmoid,
zero where the warp leaves the image.

Stage by stage, for each mode and key: the certainty draw and the
inverse-density draw are the same index sets but for ``DRAW_DIFF`` of the
draws, in the same order but where two scores are within float rounding of
each other (XLA's log and torch's differ in the last bit on some uniforms,
and the two KDEs in the last bits); the KDE of the candidates is
within 1e-5 relative; and the returned matches are the same rows but for
``DRAW_DIFF`` of them (a near-tie swapped in the first stage hands two
candidates each other's second-stage uniforms). That allowance hides no
other difference: the port's returned rows are exactly its own two draws
composed, and JAX's second stage run on the port's own candidates gives the
port's second draw but for near-ties, so every row apart is one that a
near-tie of a stage moved. Exactly equal scores must come in JAX's order,
lower index first: ``torch.topk`` gave them in another order before the
port's draw became a stable sort."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roma_tpu.ops.kde import kde as jax_kde
from roma_tpu.ops.sampling import balanced_sample as jax_balanced_sample
from roma_tpu.ops.sampling import multinomial_no_replacement as jax_multinomial
from roma_tpu_torch.ops import balanced_sample, kde, multinomial_no_replacement
from roma_tpu_torch.tools import crossimpl as xi

port_sampling = importlib.import_module("roma_tpu_torch.ops.sampling")

HW = (160, 224)
NUM = 2500
MODES = ("threshold_balanced", "balanced", "threshold", "sample")
KEYS = (0, 1)
DRAW_DIFF = 1e-3
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(scope="module")
def scene():
    h, w = HW
    grid = np.stack(np.meshgrid(np.linspace(-1 + 1 / w, 1 - 1 / w, w), np.linspace(-1 + 1 / h, 1 - 1 / h, h),
                                indexing="xy"), -1)
    to_b = xi.gt_warp(xi.make_scene(0, HW), grid, "AtoB")
    warp = np.concatenate((grid, to_b), -1).reshape(-1, 4).astype(np.float32)
    rs = np.random.RandomState(0)
    cert = 1 / (1 + np.exp(-2.0 * rs.randn(h * w)))
    cert = np.where(np.abs(to_b.reshape(-1, 2)).max(-1) < 1, cert, 0.0).astype(np.float32)
    assert 0.5 < (cert > 0).mean() < 0.95 and 0.1 < (cert < 0.05).mean()  # both regimes of the threshold
    return warp, cert


def uniforms(key, *shapes):
    """JAX's Gumbel uniforms: one draw for one shape, the split key's two
    halves for two."""
    keys = [key] if len(shapes) == 1 else jax.random.split(key)
    return [np.asarray(jax.random.uniform(k, s, jnp.float32, minval=TINY, maxval=1.0)) for k, s in zip(keys, shapes)]


def feed(monkeypatch, us):
    """torch.rand returns ``us`` in order, each checked against the shape
    asked for; returns the list, empty once every uniform was taken."""
    queue = list(us)

    def rand(shape, generator=None, device=None):
        u = queue.pop(0)
        assert tuple(shape) == u.shape
        return torch.from_numpy(u.copy())

    monkeypatch.setattr(torch, "rand", rand)
    return queue


def apart(a, b) -> float:
    return len(set(np.asarray(a).tolist()) ^ set(np.asarray(b).tolist())) / 2 / len(a)


def same_draw(t_idx, j_idx, weights, us, what):
    """The port's draw ``t_idx`` is JAX's ``j_idx`` but for DRAW_DIFF of the
    set, and where the order differs the two scores (JAX's, in float64 from
    the same weights and uniforms) are a near-tie."""
    assert apart(t_idx, j_idx) <= DRAW_DIFF, what
    with np.errstate(divide="ignore"):  # weight 0 scores -inf
        score = np.log(weights.astype(np.float64)) - np.log(-np.log(us.astype(np.float64)))
    for i in np.nonzero(t_idx != j_idx)[0]:
        a, b = score[t_idx[i]], score[j_idx[i]]
        assert abs(a - b) <= 1e-5 * max(1.0, abs(a)), (what, i, a, b)


def test_the_uniforms_are_jax_gumbel_draws():
    key, shape = jax.random.PRNGKey(3), (1000,)
    (u,) = uniforms(key, shape)
    want = -jnp.log(-jnp.log(jnp.asarray(u)))  # XLA's log: numpy's differs in the last bit
    np.testing.assert_array_equal(np.asarray(jax.random.gumbel(key, shape, jnp.float32)), np.asarray(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", KEYS)
def test_balanced_sample_equals_jax_on_identical_uniforms(scene, monkeypatch, mode, seed):
    warp, cert = scene
    n = cert.shape[0]
    key = jax.random.PRNGKey(seed)
    j_m, j_c = jax_balanced_sample(key, jnp.asarray(warp), jnp.asarray(cert), NUM, thresh=0.05, mode=mode)
    balanced = "balanced" in mode
    exp = min(4 * NUM, n)
    us = uniforms(key, (n,), (exp,)) if balanced else uniforms(key, (n,))
    left = feed(monkeypatch, us)
    stages = []  # (weights, draw) of each of the port's draws inside balanced_sample

    def recorded(weights, num, generator=None):
        idx = multinomial_no_replacement(weights, num, generator)
        stages.append((weights.numpy().copy(), idx.numpy().copy()))
        return idx

    monkeypatch.setattr(port_sampling, "multinomial_no_replacement", recorded)
    t_m, t_c = balanced_sample(torch.from_numpy(warp), torch.from_numpy(cert), NUM, thresh=0.05, mode=mode)
    assert not left and len(stages) == len(us)
    monkeypatch.undo()
    # the port returns exactly the rows its own draws pick
    own = stages[0][1][stages[1][1]] if balanced else stages[0][1]
    np.testing.assert_array_equal(t_m.numpy(), warp[own])
    np.testing.assert_array_equal(t_c.numpy(), stages[0][0][own])

    c = np.where(cert > 0.05, 1.0, cert).astype(np.float32) if "threshold" in mode else cert
    k1, k2 = jax.random.split(key) if balanced else (key, None)
    j_i = np.asarray(jax_multinomial(k1, jnp.asarray(c), exp if balanced else NUM))
    feed(monkeypatch, us[:1])
    t_i = multinomial_no_replacement(torch.from_numpy(c), exp if balanced else NUM).numpy()
    monkeypatch.undo()
    np.testing.assert_array_equal(stages[0][1], t_i)
    same_draw(t_i, j_i, c, us[0], "certainty draw")
    if balanced:
        cand = warp[j_i]
        j_den = np.asarray(jax_kde(jnp.asarray(cand), std=0.1))
        t_den = kde(torch.from_numpy(cand), std=0.1).numpy()
        np.testing.assert_allclose(t_den, j_den, rtol=1e-5, atol=0)
        p = np.where(j_den < 10.0, 1e-7, 1.0 / (j_den + 1.0)).astype(np.float32)
        j_j = np.asarray(jax_multinomial(k2, jnp.asarray(p), NUM))
        feed(monkeypatch, us[1:])
        t_j = multinomial_no_replacement(torch.from_numpy(p), NUM).numpy()
        monkeypatch.undo()
        same_draw(t_j, j_j, p, us[1], "inverse-density draw")
        # JAX's second stage on the port's own candidates gives the port's second draw
        t_cand_den = np.asarray(jax_kde(jnp.asarray(warp[stages[0][1]]), std=0.1))
        p_own = np.where(t_cand_den < 10.0, 1e-7, 1.0 / (t_cand_den + 1.0)).astype(np.float32)
        np.testing.assert_allclose(stages[1][0], p_own, rtol=1e-5, atol=0)
        same_draw(stages[1][1], np.asarray(jax_multinomial(k2, jnp.asarray(p_own), NUM)), p_own, us[1],
                  "inverse-density draw on the port's candidates")
    rows = lambda m, c: {tuple(r) for r in np.concatenate((np.asarray(m), np.asarray(c)[:, None]), 1).tolist()}
    assert t_m.shape == (NUM, 4) and t_c.shape == (NUM,)
    assert 1 - len(rows(t_m, t_c) & rows(j_m, j_c)) / NUM <= DRAW_DIFF, "returned matches"


def test_equal_scores_come_lower_index_first(monkeypatch):
    """Exact ties, as repeated float32 uniforms make them, in jax.lax.top_k's
    order."""
    w = np.ones(64, np.float32)
    u = np.full(64, 0.5, np.float32)
    u[[5, 9, 40]] = 0.9
    feed(monkeypatch, [u])
    got = multinomial_no_replacement(torch.from_numpy(w), 6).numpy()
    monkeypatch.undo()
    want = np.asarray(jax.lax.top_k(-jnp.log(-jnp.log(jnp.asarray(u))), 6)[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [5, 9, 40, 0, 1, 2])
