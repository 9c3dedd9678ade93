"""Weighted sampling without replacement + balanced match sampling
(counterpart of roma_tpu/ops/sampling.py).

Draws use the Gumbel top-k trick: the top-k of log(w) + Gumbel noise is k
draws without replacement with p proportional to w. The noise comes from an
explicit ``torch.Generator`` and is drawn on the generator's device, then
moved to the weights': the same generator gives the same uniforms to weights
on the card and on the CPU. It is not the JAX key stream; fed JAX's uniforms,
the draws are JAX's (tests/test_torch_sampling_uniforms.py).

Equal scores are ordered as ``jax.lax.top_k`` orders them, lower index
first: float32 uniforms repeat (a 23-bit grid: ~77 equal pairs are expected
among 36k draws), and in the balanced modes the candidates' order decides which
second-stage uniform each one gets. ``torch.topk`` leaves that order open,
so the draw is a stable descending sort.
"""
from __future__ import annotations

import torch

from .kde import kde


def multinomial_no_replacement(
    weights: torch.Tensor, num: int, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Indices of ``num`` draws without replacement, p proportional to
    ``weights`` (>= 0); weight 0 is never drawn while others remain."""
    draw_on = weights.device if generator is None else generator.device
    u = torch.rand(weights.shape, generator=generator, device=draw_on).to(weights.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    scores = torch.log(weights.float()) + gumbel
    return torch.sort(scores, descending=True, stable=True).indices[:num]


def balanced_sample(
    matches: torch.Tensor,
    certainty: torch.Tensor,
    num: int,
    generator: torch.Generator | None = None,
    thresh: float = 0.05,
    mode: str = "threshold_balanced",
):
    """Sparse sampling of matches (N, 4) by certainty (N,) -> (matches
    (num, 4), certainty (num,)), in the four modes of the JAX package: with
    "threshold" in ``mode``, certainty above ``thresh`` saturates to 1; with
    "balanced", 4*num candidates are drawn by certainty, then num of them by
    inverse KDE density; without it, num are drawn by certainty alone."""
    cert = certainty.float()
    if "threshold" in mode:
        cert = torch.where(cert > thresh, torch.ones_like(cert), cert)
    if "balanced" not in mode:
        idx = multinomial_no_replacement(cert, num, generator)
        return matches[idx], cert[idx]
    expansion = min(4 * num, cert.shape[0])
    good_idx = multinomial_no_replacement(cert, expansion, generator)
    good_matches, good_cert = matches[good_idx], cert[good_idx]
    density = kde(good_matches, std=0.1)
    p = 1.0 / (density + 1.0)
    p = torch.where(density < 10.0, torch.full_like(p, 1e-7), p)
    bal_idx = multinomial_no_replacement(p, min(num, expansion), generator)
    return good_matches[bal_idx], good_cert[bal_idx]
