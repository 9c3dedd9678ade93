"""On the card, at each engine cell's own sizes: the program's module spans
(``roma.net.*``) inside each pass span. Their device times (CUDA events on
the current stream) of a pass sum to no more than the pass span's own, and
every batch records each module span the match runs. Prints each module's
device time a batch and its share of the two passes'. Skipped without a
CUDA device; run on the card with

    python3 -m pytest perfbench/tests/test_perfbench_net_spans_card.py -m card -s
"""
import json
import time
from collections import Counter, defaultdict

import pytest
import torch

from perfbench.lib import harness, spec

SEED = 3_000_000_021
BATCHES = 3
SLACK_MS = 0.01  # the events' resolution (about half a microsecond each), with room
PASSES = {"roma.match.coarse": 1 + 1 + 1 + 5, "roma.match.upsample": 1 + 4}  # VGG, DINOv2, GM, refiners


@pytest.mark.card
@pytest.mark.parametrize("name", ["match560_engine_b8", "match1344_engine_b4"])
def test_module_spans_sum_within_their_pass(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from roma_tpu_torch.utils import profiling

    cell = spec.load_cell(name)
    run = harness.Run(cell, SEED, 1.0, False, torch.device("cuda"), time.perf_counter())
    s = cell.driver.setup(run)
    try:
        bs = cell.mix["batch_size"]
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in s.engine.match_paths(s.files[:BATCHES * bs]):
                pass
            torch.cuda.synchronize()
        rec = profiling.recorded_spans()["spans"]
    finally:
        cell.driver.release(run, s)
        s.tmp.cleanup()
    by_id = {r["id"]: r for r in rec}
    net = [r for r in rec if r["name"].startswith("roma.net.")]
    passes = [r for r in rec if r["name"] in PASSES]
    assert len(passes) == 2 * BATCHES
    per_module, pass_ms = defaultdict(float), 0.0
    for p in passes:
        mine = [r for r in net if r["parent"] == p["id"]]
        assert len(mine) == PASSES[p["name"]], (p["name"], Counter(r["name"] for r in mine))
        assert all(r["unit"] == p["unit"] and r["device_ms"] is not None for r in mine)
        inside = sum(r["device_ms"] for r in mine)
        assert inside <= p["device_ms"] + SLACK_MS, (p["name"], inside, p["device_ms"])
        pass_ms += p["device_ms"]
        for r in mine:
            per_module[r["name"].rsplit(".", 1)[0] if ".refine." in r["name"] else r["name"]] += r["device_ms"]
    assert all(by_id[r["parent"]]["name"] in PASSES for r in net)
    print(json.dumps({"cell": name, "card": harness.power_limit(), "pass_ms_a_batch": pass_ms / BATCHES,
                      "module_ms_a_batch": {k: v / BATCHES for k, v in sorted(per_module.items())},
                      "module_share": {k: v / pass_ms for k, v in sorted(per_module.items())}}))
