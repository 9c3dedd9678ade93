"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells (workloads),
their configurations, traffic mixes and metrics. Each of those is a file of
its own under ``perfbench/``:

* ``configs/<config>.json``: the model configuration as it is run;
* ``mixes/<traffic>.json``: the traffic's parameters and the name of the
  driver that plays it, ``drivers/<driver>.py``;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

A missing file is an error: nothing falls back to another file.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    """A cell, configuration, mix, driver or metric that the benchmark's
    files do not hold."""


def _must(path: Path, what: str) -> Path:
    if not path.is_file():
        raise SpecError(f"{what}: {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path} does not exist")
    return path


def load_json(path: Path, what: str) -> dict:
    return json.loads(_must(path, what).read_text())


def load_module(path: Path, what: str):
    _must(path, what)
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config_name: str
    traffic: str
    config: dict
    mix: dict
    driver: object
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict


def applies(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    """Whether a metric is reported in ``cell``: listed there by its
    ``workloads`` key, or, without one, wherever the end-to-end metric it
    moves is (per-layer) or everywhere (end-to-end)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, bench_file: Path | None = None) -> Cell:
    bench = load_json(bench_file or ROOT / "BENCHMARK.json", "the benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"workload {name!r} is not in BENCHMARK.json (cells: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names configuration {w['config']!r}, which BENCHMARK.json does not list")
    config = load_json(ROOT / configs[w["config"]]["file"], f"configuration {w['config']!r}")
    mix = load_json(BENCH_DIR / "mixes" / f"{w['traffic']}.json", f"traffic {w['traffic']!r}")
    driver = load_module(BENCH_DIR / "drivers" / f"{mix['driver']}.py", f"driver {mix['driver']!r}")
    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, name, e2e_names)]
    readers = {m["name"]: load_module(BENCH_DIR / "metrics" / f"{m['name']}.py", f"metric {m['name']!r}")
               for m in per_layer}
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config, mix, driver, e2e, per_layer, readers)
