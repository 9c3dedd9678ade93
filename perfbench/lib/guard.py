"""What a run refuses: a machine without the cards the cell asks for, and a
process that has loaded the JAX stack or the JAX package.

Modules are compared by their top-level name, the part before the first
dot, and whole: ``roma_tpu_torch`` (the program) is not ``roma_tpu`` (the
JAX package), though its name begins with it.
"""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "roma_tpu")


class Refused(RuntimeError):
    """The run cannot be measured here."""


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (``names``, default ``sys.modules``) whose top-level
    name is one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def require_no_jax(names=None):
    found = forbidden_modules(names)
    if found:
        raise Refused(f"modules of the JAX stack or the JAX package are loaded: {', '.join(found[:20])}")


def require_cards(n: int):
    """At least ``n`` CUDA devices, else :class:`Refused`: a run never
    measures the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell needs {n} CUDA devices, {torch.cuda.device_count()} present")
