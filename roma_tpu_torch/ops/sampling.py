"""Weighted sampling without replacement + balanced match sampling
(counterpart of roma_tpu/ops/sampling.py).

Draws use the Gumbel top-k trick: the top-k of log(w) + Gumbel noise is k
draws without replacement with p proportional to w. The noise comes from an
explicit ``torch.Generator``; it is not the JAX key stream, so the tests
check sampling by its properties.
"""
from __future__ import annotations

import torch

from .kde import kde


def multinomial_no_replacement(
    weights: torch.Tensor, num: int, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Indices of ``num`` draws without replacement, p proportional to
    ``weights`` (>= 0); weight 0 is never drawn while others remain."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.topk(torch.log(weights.float()) + gumbel, num).indices


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
