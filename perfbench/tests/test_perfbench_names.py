"""BENCHMARK.json keeps to the benchmark's contract: names and units of the
allowed characters and lengths, exactly the allowed keys, bounds in range,
files under the benchmark's own directory, every cell reporting set-up
time, another end-to-end metric and a per-layer metric."""
import json
import re

import pytest

from perfbench.lib import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_names_are_unique_and_cells_are_whole():
    names = [m["name"] for m in METRICS] + [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"])
        reported = {n for n, m in e2e.items() if spec.applies(m, w["name"], set())}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if spec.applies(m, w["name"], reported)]
        assert layer and all(m["moves"] in reported for m in layer)
    assert e2e["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("c", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["reduced"]) <= 16
    assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    assert c["file"].startswith(BENCH["paths"][0] + "/")
    body = json.loads((spec.ROOT / c["file"]).read_text())
    assert body["name"] == c["name"] and body["reduced"] == c["reduced"] and body["source"] == c["source"]
    assert sum(1 for w in BENCH["workloads"] if w["config"] == c["name"]) >= 1


def test_files_are_named_from_names():
    for path in (spec.BENCH_DIR).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
