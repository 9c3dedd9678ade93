"""Reading the device from torch.profiler: busy time as a union of intervals,
device time by kernel name, and the idle gaps named by what the host did.

A traced sub-window of the run is captured with CUDA and CPU activities and
exported as a Chrome trace. Every event of category ``kernel``,
``gpu_memcpy`` or ``gpu_memset`` is device work; the device is busy where
any of them runs, on any stream, so two streams that overlap count once.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def span(name: str, on: bool = True):
    """A named range of the benchmark's own in a traced run (the idle gaps
    are named by the innermost one); nothing in an untraced run."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


class Tracer:
    """``start()`` / ``stop()`` around a steady part of the window; after
    ``stop()``, :attr:`reading` holds the device reading (see :func:`read`)."""

    def __init__(self, out_dir: Path):
        self.out_dir = out_dir
        self.prof = None
        self.reading = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.t_begin = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        """Stop, read the trace; ``spent_s`` is the whole traced stretch with
        the profiler's start, stop and reading, which rates leave out."""
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"trace_{os.getpid()}.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        try:
            self.reading = read(json.loads(path.read_text()), wall)
        finally:
            path.unlink(missing_ok=True)
        self.spent_s = time.perf_counter() - self.t_begin


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _host_at(host: list[dict], t: float) -> str:
    """The innermost host event running at time ``t`` (us), by name."""
    best = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["ts"] >= best["ts"]):
            best = e
    return best["name"] if best is not None else "host: no traced op"


def read(trace: dict, wall_s: float, top: int = 10) -> dict:
    """The device reading of one traced window.

    Returns ``busy_s`` (the union of device work, seconds), ``window_s``
    (the traced window: from the first to the last event on either side,
    at least ``wall_s`` as the host clock read it), ``kernels`` ({name:
    [seconds, calls]}), ``device_ops`` (the ``top`` names by total time) and
    ``idle_gaps`` (the ``top`` longest gaps in device work, each named by
    the innermost host op running in its middle)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if not dev:
        return {"busy_s": 0.0, "window_s": wall_s, "kernels": {}, "device_ops": [], "idle_gaps": []}
    ivals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    window_s = max((hi - lo) * 1e-6, wall_s)
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += float(e["dur"]) * 1e-6
        by_name[e["name"]][1] += 1
    g = sorted(gaps(ivals, lo, hi), key=lambda se: se[0] - se[1])[:top]
    host_sorted = sorted(host, key=lambda e: e["ts"])
    idle = [[_host_at(host_sorted, (s + e) / 2), (e - s) * 1e-6] for s, e in g]
    ops = sorted(([n, v[0]] for n, v in by_name.items()), key=lambda nv: -nv[1])[:top]
    return {"busy_s": union_length(ivals) * 1e-6, "window_s": window_s, "kernels": dict(by_name),
            "device_ops": ops, "idle_gaps": idle}


def idle_share(reading: dict | None) -> float | None:
    """100 * (1 - busy / window) of a reading; None without device work."""
    if not reading or reading.get("busy_s", 0.0) <= 0 or reading.get("window_s", 0.0) <= 0:
        return None
    return 100.0 * (1.0 - reading["busy_s"] / reading["window_s"])
