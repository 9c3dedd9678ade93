"""Tracing, timing and metric logging (counterpart of
roma_tpu/utils/profiling.py): the program's spans and a torch.profiler trace
capture that holds them, a step-time and items/s meter with a warmup skip,
and a JSON-lines metric logger that writes on rank 0 only, with an optional
wandb sink, in place of the reference's hard-wired
``wandb.log(..., step=GLOBAL_STEP)``.

Spans. ``with annotate("roma.match"):`` marks one stage of the program.
While no torch.profiler capture runs it costs one flag check and records
nothing. During a capture each span is kept in memory: its name, host start
and end (``time.time_ns()``), thread, id, the id of the span open around it
on the same thread, and a unit id that all spans of one request, batch or
training step share; with ``device=True`` also a CUDA event pair on the
current stream, whose device time is read when the record is read. Where
the profiler sees the thread (the main thread, autograd's device threads),
the span also enters a RecordFunction of its name, so the trace names it; spans of other threads (the engine's producer) are kept in memory alone
and :func:`trace` writes them into its trace file. :func:`recorded_spans`
returns the record without clearing it; :func:`trace` clears it when it
begins, :func:`clear_spans` at any time.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import socket
import sys
import threading
import time
from typing import Any

import torch
import torch.autograd.profiler as _profiler

from ..parallel import dist

MAX_SPANS = 1 << 18  # spans kept in memory; later ones are counted as dropped

_OFF = contextlib.nullcontext()
_spans: list = []
_dropped = [0]
_record_lock = threading.Lock()
_local = threading.local()
_MAIN = threading.main_thread()
_main_stack: list = []  # the main thread's open spans, read by threads that work for it
_ids = itertools.count(1)  # span ids
_units = itertools.count(1)  # the units of root spans
_blocks = itertools.count(1)  # blocks of units from new_units, each 2^32 ids from block << 32
_new_span = object.__new__
_thread_traced = torch._C._autograd._profiler_enabled  # whether the profiler sees this thread
# a RecordFunction entered and left in C (category cpu_op in the trace): a Python-level
# record_function costs several Python calls a span under a capture
_RecordFunction = torch._C._profiler._RecordFunctionFast


def new_units(n: int) -> int:
    """Reserve ``n`` consecutive unit ids (at most 2^32; one a batch of a
    stream); returns the first."""
    if not 0 <= n <= 1 << 32:
        raise ValueError(f"new_units: n must lie in [0, 2^32], got {n}")
    return next(_blocks) << 32


class _Span:
    """One span; made by :func:`annotate` without ``__init__`` (a Python call
    less on the path a capture times)."""

    __slots__ = ("name", "id", "parent", "unit", "thread", "start_ns", "end_ns", "traced", "device", "events",
                 "device_ms", "_rf", "_stack")

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = _main_stack if threading.current_thread() is _MAIN else []
        self.id = next(_ids)
        if stack:
            self.parent = stack[-1].id
            if self.unit is None:
                self.unit = stack[-1].unit
        else:
            self.parent = None
            if self.unit is None:  # a root; on a thread that works for the main thread (autograd's) its unit
                main = _main_stack[:1] if stack is not _main_stack else ()
                self.unit = main[0].unit if main else next(_units)
        self.thread = threading.get_native_id()
        self.traced = _thread_traced()
        self.events = self.device_ms = None
        stack.append(self)
        self._stack = stack
        if self.traced:
            rf = self._rf = _RecordFunction(self.name)
            # stamped right before the RecordFunction's own stamp, which releases the GIL after it:
            # stamped after it, the start would lag the trace's by the wait for the GIL
            self.start_ns = time.time_ns()
            rf.__enter__()
        else:
            self._rf = None
            self.start_ns = time.time_ns()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self._stack.pop()
        self._stack = None
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        with _record_lock:  # threads record at once: the cap's check and the drop count need the lock
            if len(_spans) < MAX_SPANS:
                _spans.append(self)
            else:
                _dropped[0] += 1
        return False


def annotate(name: str, *, unit: int | None = None, device: bool = False):
    """The program's span ``name`` around a ``with`` block.

    Off (no torch.profiler capture running, in any thread): a shared no-op
    context. On: a span in the in-memory record, and a RecordFunction of
    the same name where the profiler sees the thread. ``unit``: the unit id
    (see :func:`new_units`); by default the enclosing span's, or a new one
    for a root span (on a thread other than the main one, the main
    thread's open unit if it has one: autograd's device threads run the
    backward of the main thread's step). ``device=True``: also the device
    time between the block's start and end on the current CUDA stream,
    gaps included."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    span = _new_span(_Span)
    span.name, span.unit, span.device = name, unit, device
    return span


def spanned(name: str):
    """Decorator: the function's body inside ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            span = _new_span(_Span)
            span.name, span.unit, span.device = name, None, False
            with span:
                return fn(*args, **kwargs)
        return run
    return wrap


def recorded_spans() -> dict:
    """The spans recorded so far, without clearing them: ``{"spans": [...],
    "dropped": n}``, each span a dict of ``name``, ``id``, ``parent``,
    ``unit``, ``thread`` (native id), ``start_ns`` and ``end_ns``
    (``time.time_ns()``), ``host_ms``, ``device_ms`` (None without a CUDA
    event pair) and ``traced`` (whether the profiler's trace holds it as a
    RecordFunction), ordered by start. Waits for the device where a
    span's device time is still open."""
    out = []
    for s in list(_spans):
        if s.events is not None:
            s.events[1].synchronize()
            s.device_ms, s.events = s.events[0].elapsed_time(s.events[1]), None
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "unit": s.unit, "thread": s.thread,
                    "start_ns": s.start_ns, "end_ns": s.end_ns, "host_ms": (s.end_ns - s.start_ns) * 1e-6,
                    "device_ms": s.device_ms, "traced": s.traced})
    out.sort(key=lambda d: d["start_ns"])
    if _dropped[0]:
        print(f"roma_tpu_torch.utils.profiling: {len(out)} spans recorded, {_dropped[0]} dropped past "
              f"MAX_SPANS={MAX_SPANS}", file=sys.stderr)
    return {"spans": out, "dropped": _dropped[0]}


def clear_spans():
    """Empty the in-memory record and its drop count."""
    with _record_lock:
        _spans.clear()
        _dropped[0] = 0


def _add_spans(path: str):
    """Write the recorded spans that the profiler did not trace (those of
    threads it does not see) into the Chrome trace at ``path``, on its own
    time base, with every span's ids in its args."""
    with open(path) as f:
        data = json.load(f)
    rec = recorded_spans()
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for s in rec["spans"]:
        if s["traced"]:
            continue
        args = {k: s[k] for k in ("id", "parent", "unit", "device_ms")}
        data["traceEvents"].append({"ph": "X", "cat": "user_annotation", "name": s["name"], "pid": pid,
                                    "tid": s["thread"], "ts": (s["start_ns"] - base) * 1e-3,
                                    "dur": (s["end_ns"] - s["start_ns"]) * 1e-3, "args": args})
    data["romaSpans"] = {"recorded": len(rec["spans"]), "dropped": rec["dropped"]}
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(dir: str):
    """Capture a torch.profiler trace of the host and the card (when there is
    one) into one Chrome trace file under ``dir``, viewable in TensorBoard or
    Perfetto. The trace also holds every ``roma.*`` span of the capture,
    the engine's producer thread's included, on the trace's time base."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    clear_spans()
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(dir, exist_ok=True)
        path = os.path.join(dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path)


class StepTimer:
    """Step-time / throughput meter with warmup skip: the first ``warmup``
    steps timed are left out of the means. The caller ends each timed step
    in a synchronize (or a value read back), or the host clock measures the
    enqueue."""

    def __init__(self, items_per_step: int = 1, warmup: int = 1):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self._times: list[float] = []
        self._t0: float | None = None
        self._steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self.warmup:
            self._times.append(dt)

    @property
    def times(self) -> list[float]:
        """The step times after the warmup, seconds."""
        return list(self._times)

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def items_per_sec(self) -> float:
        t = self.mean_step_time
        return self.items_per_step / t if t > 0 else 0.0


class MetricLogger:
    """JSON-lines metric logger; rank 0 only; optional wandb sink (used when
    the package imports)."""

    def __init__(self, use_wandb: bool = False, file: str | None = None):
        self.enabled = dist.rank() == 0
        self._file = open(file, "a") if (file and self.enabled) else None
        self._wandb = None
        if use_wandb and self.enabled:
            try:
                import wandb

                self._wandb = wandb
            except ImportError:
                pass

    def log(self, metrics: dict[str, Any], step: int):
        if not self.enabled:
            return
        payload = {k: float(v) for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(payload, step=step)
        line = json.dumps({"step": step, **payload})
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            print(line)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
