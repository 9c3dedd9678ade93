"""One run of one cell: set-up and warm-up, the measured window, the
program's state freed, the check against the plain reference, the result.

The driver named by the cell's traffic mix does the cell's own work
through four functions:

* ``setup(run) -> state``: builds the system under test, makes the
  traffic from the seed, warms up every shape the window uses, and calls
  ``run.warm_start()`` where the warm-up begins (the peak memory is read
  from there);
* ``window(run, state, tracer) -> dict``: the measured window of
  ``run.seconds``; returns the end-to-end values by metric name and fills
  ``run.records`` for the per-layer readers; with a tracer, it starts and
  stops it around a steady part of the window;
* ``release(run, state)``: frees the program's state;
* ``check(run, state) -> list[Compared]``: the comparison with the plain
  reference, once the program's state is freed.
"""
from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

from .spec import ROOT, Cell

GIB = float(2 ** 30)


@dataclass
class Compared:
    """One number of the correctness check beside its limit (at most)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float                 # perf_counter at the start of the process
    fault: str | None = None         # a planted fault (tests of the check)
    control: bool = False            # the lower-precision control in the program's place
    records: dict = field(default_factory=dict)
    t_warm: float | None = None

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def out_dir(self) -> Path:
        """Files the benchmark keeps between runs: inside the checkout."""
        return ROOT / "build" / "perfbench"

    def warm_start(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.t_warm = time.perf_counter()


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float, device="cuda",
             fault: str | None = None, control: bool = False) -> dict:
    """Run ``cell`` once; returns the result object of the run's last line
    (``checks`` holds the compared numbers). ``device="cpu"`` is for the
    tests of the harness alone: a measured run refuses the CPU before this."""
    import torch

    os.environ["ROMA_TPU_OFFLINE"] = "1"  # the zoo must never fetch weights
    dev = torch.device(device)
    run = Run(cell, seed, seconds, trace, dev, t_process, fault=fault, control=control)
    torch.manual_seed(0)
    state = cell.driver.setup(run)
    if run.t_warm is None:
        raise RuntimeError(f"driver {cell.mix['driver']!r} never called run.warm_start()")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process

    tracer = None
    if trace:
        from .profile import Tracer

        tracer = Tracer(run.out_dir / "traces")
    values = cell.driver.window(run, state, tracer)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        info = device_info(cell.chips)
        values["peak_mem_gib"] = info["memory_peak_bytes"] / GIB
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        values["peak_mem_gib"] = 0.0  # no device: only the CPU tests of the harness come here
    values["setup_s"] = setup_s
    attempted, failed = run.records.get("attempted", 0), run.records.get("failed", 0)
    cell.driver.release(run, state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.driver.check(run, state)
    del state
    gc.collect()

    metrics = {}
    if trace:
        reading = run.records.get("trace") or {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        info["busy_s"] = reading.get("busy_s", 0.0)
        info["window_s"] = reading.get("window_s", 0.0)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    result = {"correct": bool(checks) and all(c.ok for c in checks), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": info}
    if trace:
        reading = run.records.get("trace") or {}
        result["breakdown"] = {"device_ops": reading.get("device_ops", []), "idle_gaps": reading.get("idle_gaps", [])}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    result["readings"] = dict(run.records.get("check_detail", {}),
                              **{k: run.records[k] for k in ("traced_rounds", "traced_launches") if k in run.records})
    return result

