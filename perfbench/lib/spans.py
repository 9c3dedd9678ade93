"""The program's own spans (``roma_tpu_torch.utils.profiling``), read in the
run's process once the window ends: the program records them only while a
torch.profiler capture runs, so they cover the traced stretch.

Each reader of a span metric takes the mean, over the units (a request, a
batch or a training step) that recorded a span of the names it reads, of
the unit's sum of one field: ``host_ms`` (the host's wall time) or
``device_ms`` (CUDA events on the current stream, gaps included). A program
without spans, or a run that recorded none, reads None.
"""
from __future__ import annotations

from collections import defaultdict


def record() -> list[dict] | None:
    """The spans the program recorded, or None where it records none (a
    program older than its spans)."""
    from roma_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded_spans", None)
    return None if read is None else read()["spans"]


def _reads(name: str, names: tuple) -> bool:
    return any(name.startswith(p) if p.endswith(".") else name == p for p in names)


def mean_per_unit(names, field: str = "host_ms", outermost: bool = False) -> float | None:
    """The mean over units of the summed ``field`` of the spans whose name
    is in ``names`` (a str ends a prefix where it ends in "."). With
    ``outermost``, a span inside another span it reads is left out."""
    spans = record()
    if not spans:
        return None
    names = (names,) if isinstance(names, str) else tuple(names)
    chosen = {s["id"]: s for s in spans if _reads(s["name"], names)}
    per_unit = defaultdict(float)
    for s in chosen.values():
        if outermost and s["parent"] in chosen:
            continue
        if s[field] is None:
            return None
        per_unit[s["unit"]] += s[field]
    return sum(per_unit.values()) / len(per_unit) if per_unit else None
