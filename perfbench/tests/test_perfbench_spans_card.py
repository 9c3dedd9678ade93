"""On the card, at the single cell's own sizes: the program's spans against
what the benchmark measures from outside in the same requests. A span's
host start (``time.time_ns()``) lies within 100 us of its
``record_function`` event in the profiler's trace, put on the trace's
``baseTimeNanoseconds`` (the capture's first span excepted); the device time
of ``roma.match.coarse`` lies within 2% of the CUDA events that the single
cell's ``NetSpans`` hooks put around the first ``net`` call; and each kernel wrapper's
spans match its ``launches`` counter. Skipped without a CUDA device; run on
the card with

    python3 -m pytest perfbench/tests/test_perfbench_spans_card.py -m card -s
"""
import json
import time
from collections import Counter

import pytest
import torch

from perfbench.lib import harness, spec

REQUESTS = 6
SEED = 3_000_000_011


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from roma_tpu_torch.ops import KERNEL_WRAPPERS
    from roma_tpu_torch.utils import profiling

    cell = spec.load_cell("match560_single")
    single = cell.driver
    run = harness.Run(cell, SEED, 1.0, False, torch.device("cuda"), time.perf_counter())
    s = single.setup(run)
    hooks = single.NetSpans(s.matcher.net)
    profiling.clear_spans()
    before = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(REQUESTS):
            hooks.begin(time.perf_counter())
            single.request(run, s, s.pool[i % len(s.pool)])
        torch.cuda.synchronize()
    launches = {w.__name__: w.launches - before[w.__name__] for w in KERNEL_WRAPPERS}
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    outside, _ = hooks.pass_ms()
    hooks.remove()
    rec = profiling.recorded_spans()
    single.release(run, s)
    return json.loads(path.read_text()), rec, outside, launches


@pytest.mark.card
def test_span_starts_lie_on_the_trace_clock(traced):
    trace, rec, _, _ = traced
    base = trace["baseTimeNanoseconds"]
    events = [e for e in trace["traceEvents"] if e.get("cat") in ("cpu_op", "user_annotation") and e["name"].startswith("roma.")]
    ours = [s for s in rec["spans"] if s["traced"]]
    first = min(s["start_ns"] for s in ours)
    gaps = []
    for name in sorted({s["name"] for s in ours}):
        mine = sorted(s["start_ns"] for s in ours if s["name"] == name)
        theirs = sorted(base + 1000 * e["ts"] for e in events if e["name"] == name)
        assert len(mine) == len(theirs), name
        gaps += [((a - b) * 1e-3, name, i) for i, (a, b) in enumerate(zip(mine, theirs)) if a != first]
    gaps.sort()
    print(json.dumps({"clock_us": {"n": len(gaps), "median": gaps[len(gaps) // 2][0], "lowest": gaps[:5],
                                   "highest": gaps[-3:]}}))
    assert max(abs(g[0]) for g in gaps) < 100.0


@pytest.mark.card
def test_the_coarse_span_reads_the_outside_coarse_pass(traced):
    _, rec, outside, _ = traced
    inside = [s["device_ms"] for s in rec["spans"] if s["name"] == "roma.match.coarse"]
    assert len(inside) == len(outside) == REQUESTS
    ratios = [a / b for a, b in zip(inside, outside)]
    print(json.dumps({"coarse_ms": {"inside": inside, "outside": outside}}))
    assert all(abs(r - 1) < 0.02 for r in ratios), ratios


@pytest.mark.card
def test_kernel_wrapper_spans_match_the_launch_counters(traced):
    _, rec, _, launches = traced
    calls = Counter(s["name"][len("roma.ops."):] for s in rec["spans"] if s["name"].startswith("roma.ops."))
    print(json.dumps({"ops_spans": calls, "launches": {k: v for k, v in launches.items() if v}}))
    for name in ("fused_attention_packed", "local_correlation", "warp_sample"):  # one launch a call
        assert calls[name] == launches[name] > 0, name
    d = "fused_refiner_stack"  # one launch a folded block of a call
    assert calls[d] > 0 and launches[d] % calls[d] == 0
    assert set(calls) == {k for k, v in launches.items() if v}
