"""The harness finds each cell's configuration, traffic mix, driver and
per-layer metrics by name, and refuses a name whose file is missing."""
import copy
import json

import pytest

from perfbench.lib import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_its_files(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert {"setup", "window", "release", "check"} <= set(dir(cell.driver))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(hasattr(r, "read") for r in cell.readers.values())
    assert set(cell.mix["limits"])


def _broken(tmp_path, edit):
    b = copy.deepcopy(BENCH)
    edit(b)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    return path


@pytest.mark.parametrize("what, edit", [
    ("cell", lambda b: None),
    ("traffic", lambda b: b["workloads"][0].update(traffic="no_such_mix")),
    ("config", lambda b: b["workloads"][0].update(config="no_such_config")),
    ("config file", lambda b: b["configs"][0].update(file="perfbench/configs/no_such_config.json")),
    ("metric", lambda b: b["per_layer"].append(dict(b["per_layer"][0], name="no_such_metric",
                                                    workloads=[b["workloads"][0]["name"]]))),
])
def test_a_missing_name_is_refused(tmp_path, what, edit):
    path = _broken(tmp_path, edit)
    name = "no_such_cell" if what == "cell" else BENCH["workloads"][0]["name"]
    if what == "config file":
        name = next(w["name"] for w in BENCH["workloads"] if w["config"] == BENCH["configs"][0]["name"])
    with pytest.raises(spec.SpecError):
        spec.load_cell(name, path)


def test_a_missing_driver_is_refused(tmp_path, monkeypatch):
    mixes = tmp_path / "mixes"
    mixes.mkdir()
    (mixes / "lone.json").write_text(json.dumps({"driver": "no_such_driver", "limits": {}}))
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    path = _broken(tmp_path, lambda b: b["workloads"][0].update(traffic="lone"))
    with pytest.raises(spec.SpecError):
        spec.load_cell(BENCH["workloads"][0]["name"], path)
