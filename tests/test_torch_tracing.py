"""The port's spans (roma_tpu_torch/utils/profiling.py) on the CPU, at
RoMaConfig.tiny() with the weights of tests/torch_port_fixtures.py: nothing
is recorded without a torch.profiler capture; under one, a match, the
engine, a training step and the kernel wrappers record their spans with the
right parents, units, threads and intervals; ``trace(dir)`` writes one
Chrome trace holding them on the trace's own clock; the private profiler
flag the off path reads behaves as the spans assume."""
from __future__ import annotations

import contextlib
import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from roma_tpu_torch.datasets.loader import to_device
from roma_tpu_torch.models.roma import RegressionMatcher
from roma_tpu_torch.models.zoo import train_net
from roma_tpu_torch.ops import KERNEL_WRAPPERS
from roma_tpu_torch.serving import MatchEngine
from roma_tpu_torch.tools import convergence_run as conv
from roma_tpu_torch.train import make_train_step
from roma_tpu_torch.utils import profiling
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

H = W = 56
UP = (64, 64)


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def model():
    return RegressionMatcher(port_net(seeded_tiny_variables(0)), h=H, w=W, upsample_res=UP)


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(0)
    return [Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)) for h, w in ((80, 100), (70, 90))]


@pytest.fixture(scope="module")
def trainer():
    net = train_net(TINY, "cpu", seed=0)
    step = make_train_step(net, conv.LOSSES, conv.optimizer(net, 10))
    batch = conv.make_batch(np.random.RandomState(0), 2, 112)
    return step, batch


def _capture():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(name=None):
    rec = profiling.recorded_spans()
    assert rec["dropped"] == 0
    return [s for s in rec["spans"] if name is None or s["name"] == name]


def _inside(child, parent):
    return parent["start_ns"] <= child["start_ns"] <= child["end_ns"] <= parent["end_ns"]


def test_the_private_profiler_flag_behaves_as_the_spans_assume():
    """``torch.autograd.profiler._is_profiler_enabled`` is the off path's
    one check: it must read True in every thread during a capture and
    False outside; the per-thread C flag must be False in a thread the
    profiler does not see (why such a thread's spans stay in memory)."""
    import torch.autograd.profiler as ap

    seen = {}

    def worker():
        seen.update(module=ap._is_profiler_enabled, c=torch._C._autograd._profiler_enabled())

    assert ap._is_profiler_enabled is False and profiling.annotate("x") is profiling.annotate("y")
    with _capture():
        assert ap._is_profiler_enabled is True and torch._C._autograd._profiler_enabled()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen == {"module": True, "c": False}
    assert ap._is_profiler_enabled is False and not torch._C._autograd._profiler_enabled()


def test_the_c_level_record_function_names_its_range_in_the_trace(tmp_path):
    """The spans enter ``torch._C._profiler._RecordFunctionFast`` (a
    RecordFunction entered and left in C): it must take the name and record
    one host event of it in the trace."""
    with _capture() as prof:
        rf = torch._C._profiler._RecordFunctionFast("roma.test.fast")
        rf.__enter__()
        torch.ones(4).sum()
        rf.__exit__(None, None, None)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "roma.test.fast" and e.get("ph") == "X" for e in events) == 1


def test_nothing_is_recorded_without_a_capture(model, images, trainer, tmp_path):
    model.match(*images)
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"{i}.png"))
        im.save(paths[-1])
    for _ in MatchEngine(model, batch_size=2).match_paths([tuple(paths)] * 3):
        pass
    step, batch = trainer
    step(to_device(batch, "cpu"))
    assert profiling.recorded_spans() == {"spans": [], "dropped": 0}


def test_match_records_its_stages_as_one_unit(model, images):
    with _capture():
        model.match(*images)
    roots = _spans("roma.match")
    assert len(roots) == 1 and roots[0]["parent"] is None
    root = roots[0]
    by_name = Counter(s["name"] for s in _spans() if not s["name"].startswith(("roma.ops.", "roma.net.")))
    assert by_name == {"roma.match": 1, "roma.match.prep": 1, "roma.match.resize": 2, "roma.match.coarse": 1,
                       "roma.match.upsample": 1}  # one resize a canvas, both images in it, on every device
    prep = _spans("roma.match.prep")[0]
    for s in _spans():
        assert s["unit"] == root["unit"] and s["thread"] == threading.get_native_id() and s["traced"]
        if s["name"] == "roma.match.resize":
            assert s["parent"] == prep["id"] and _inside(s, prep)
        elif s["name"] in ("roma.match.prep", "roma.match.coarse", "roma.match.upsample"):
            assert s["parent"] == root["id"] and _inside(s, root)
        assert s["device_ms"] is None  # no CUDA event pair on the CPU
    coarse, up = _spans("roma.match.coarse")[0], _spans("roma.match.upsample")[0]
    assert prep["end_ns"] <= coarse["start_ns"] and coarse["end_ns"] <= up["start_ns"]


NET_SPANS = {"roma.match.coarse": ["roma.net.vgg", "roma.net.dinov2", "roma.net.gm", "roma.net.refine.s16",
                                    "roma.net.refine.s8", "roma.net.refine.s4", "roma.net.refine.s2",
                                    "roma.net.refine.s1"],
             "roma.match.upsample": ["roma.net.vgg", "roma.net.refine.s8", "roma.net.refine.s4",
                                     "roma.net.refine.s2", "roma.net.refine.s1"]}


def _net_spans_by_pass(passes: list[dict]) -> dict:
    """The roma.net.* spans directly inside each pass span, in start order,
    checked to lie inside it and to take its unit; the kernel wrappers'
    spans of a refiner call inside its refine span."""
    out = {}
    for p in passes:
        mine = [s for s in _spans() if s["name"].startswith("roma.net.") and s["parent"] == p["id"]]
        assert all(_inside(s, p) and s["unit"] == p["unit"] and s["device_ms"] is None for s in mine)
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(mine, mine[1:]))
        out[p["id"]] = [s["name"] for s in mine]
        for r in mine:
            if r["name"].startswith("roma.net.refine."):
                ops = [s for s in _spans() if s["parent"] == r["id"]]
                assert ops and all(s["name"].startswith("roma.ops.") and _inside(s, r) for s in ops)
    return out


def test_match_records_the_net_modules_inside_each_pass(model, images):
    """VGG in both passes, DINOv2 and the global match in the coarse one,
    a refine span a scale; no other roma.net.* span anywhere."""
    assert profiling.annotate("roma.net.vgg", device=True) is profiling.annotate("roma.net.gm", device=True)
    with _capture():
        model.match(*images)
    for name, want in NET_SPANS.items():
        (p,) = _spans(name)
        assert _net_spans_by_pass([p])[p["id"]] == want
    assert sum(s["name"].startswith("roma.net.") for s in _spans()) == sum(map(len, NET_SPANS.values()))


def test_engine_records_the_net_modules_under_each_batch(model, images, tmp_path):
    """In MatchEngine each batch's module spans nest in its match's passes,
    under ``roma.engine.dispatch``, and take the batch's unit."""
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"{i}.png"))
        im.save(paths[-1])
    with _capture():
        list(MatchEngine(model, batch_size=2).match_paths([tuple(paths)] * 3))
    dispatch = {s["unit"]: s for s in _spans("roma.engine.dispatch")}
    matches = {s["id"]: s for s in _spans("roma.match")}
    assert len(dispatch) == len(matches) == 2
    for name, want in NET_SPANS.items():
        passes = _spans(name)
        assert len(passes) == 2
        for p in passes:
            m = matches[p["parent"]]
            assert m["parent"] == dispatch[p["unit"]]["id"] and m["unit"] == p["unit"]
        assert all(got == want for got in _net_spans_by_pass(passes).values())
    net = [s for s in _spans() if s["name"].startswith("roma.net.")]
    assert len(net) == 2 * sum(map(len, NET_SPANS.values())) and {s["unit"] for s in net} == set(dispatch)


def test_each_kernel_wrapper_span_counts_its_calls(model, images):
    """A ``roma.ops.<wrapper>`` span a call of the wrapper, on the plain path
    too. Calls are counted by the interpreter's profile hook (the
    ``launches`` counters count CUDA launches alone and stay put on the
    CPU; the card test holds the spans to them)."""
    codes = {w.__wrapped__.__code__: w.__name__ for w in KERNEL_WRAPPERS}
    calls = Counter()
    launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}

    def hook(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            calls[codes[frame.f_code]] += 1

    with _capture():
        sys.setprofile(hook)
        try:
            model.match(*images)
        finally:
            sys.setprofile(None)
    spans = Counter(s["name"][len("roma.ops."):] for s in _spans() if s["name"].startswith("roma.ops."))
    assert spans == calls and {"fused_attention_packed", "local_correlation", "warp_sample"} <= set(spans)
    assert {w.__name__: w.launches for w in KERNEL_WRAPPERS} == launches
    unit = _spans("roma.match")[0]["unit"]
    assert all(s["unit"] == unit and s["parent"] is not None for s in _spans() if s["name"].startswith("roma.ops."))


def test_engine_records_each_batch_as_a_unit(model, images, tmp_path):
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"{i}.png"))
        im.save(paths[-1])
    with _capture():
        results = list(MatchEngine(model, batch_size=2).match_paths([tuple(paths)] * 5))
    assert len(results) == 5
    main = threading.get_native_id()
    prep = _spans("roma.engine.prep")
    assert len(prep) == 3 and all(s["thread"] != main and not s["traced"] for s in prep)
    units = [s["unit"] for s in prep]
    assert units == list(range(units[0], units[0] + 3))
    for name in ("roma.engine.dispatch", "roma.engine.gather", "roma.engine.to_device"):
        got = _spans(name)
        assert sorted(s["unit"] for s in got) == units, name
        assert all(s["thread"] == main for s in got)
    waits = _spans("roma.engine.wait")  # one more: the wait for the end of the stream
    assert [s["unit"] for s in waits] == units + [units[-1] + 1]
    dispatch = {s["unit"]: s for s in _spans("roma.engine.dispatch")}
    for s in _spans("roma.engine.to_device"):
        assert s["parent"] == dispatch[s["unit"]]["id"] and _inside(s, dispatch[s["unit"]])
    for s in _spans("roma.match"):
        assert s["parent"] in {d["id"] for d in dispatch.values()}


def test_train_step_records_its_phases_in_order(trainer):
    step, batch = trainer
    with _capture():
        step(to_device(batch, "cpu"))
    assert len(_spans("roma.loader.to_device")) == 1
    root = _spans("roma.train.step")
    assert len(root) == 1
    phases = [s for s in _spans() if s["parent"] == root[0]["id"]]
    assert [s["name"] for s in phases] == ["roma.train.forward", "roma.train.backward", "roma.train.optimizer"]
    assert all(_inside(s, root[0]) and s["unit"] == root[0]["unit"] for s in phases)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(phases, phases[1:]))


def test_the_record_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with _capture():
        for i in range(5):
            with profiling.annotate(f"roma.test.{i}", device=True):
                pass
    rec = profiling.recorded_spans()
    assert [s["name"] for s in rec["spans"]] == ["roma.test.0", "roma.test.1", "roma.test.2"]
    assert rec["dropped"] == 2 and profiling.recorded_spans()["dropped"] == 2  # reading does not clear
    profiling.clear_spans()
    assert profiling.recorded_spans() == {"spans": [], "dropped": 0}


def test_threads_recording_at_once_lose_no_span(monkeypatch):
    """More threads than cores, a short switch interval, a cap they pass:
    every span is kept or counted as dropped, and no id is given twice."""
    threads, each = 16, 200
    monkeypatch.setattr(profiling, "MAX_SPANS", threads * each // 2)
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(each):
                with profiling.annotate(f"roma.test.{k}"), profiling.annotate("roma.test.inner"):
                    pass

        with _capture():
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(was)
    rec = profiling.recorded_spans()
    assert len(rec["spans"]) == threads * each // 2 and rec["dropped"] == threads * each * 3 // 2
    assert len({s["id"] for s in rec["spans"]}) == len(rec["spans"])
    outer = {s["id"]: s for s in rec["spans"] if s["name"] != "roma.test.inner"}
    for s in rec["spans"]:
        if s["name"] == "roma.test.inner" and s["parent"] in outer:
            assert s["thread"] == outer[s["parent"]]["thread"] and s["unit"] == outer[s["parent"]]["unit"]


def test_trace_writes_one_trace_with_every_span_on_its_clock(model, images, tmp_path):
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"{i}.png"))
        im.save(paths[-1])
    with _capture(), profiling.annotate("roma.test.before"):
        pass
    assert _spans("roma.test.before")
    out = tmp_path / "trace"
    with profiling.trace(str(out)):
        list(MatchEngine(model, batch_size=2).match_paths([tuple(paths)] * 4))
    files = list(out.rglob("*.json"))
    assert len(files) == 1
    data = json.loads(files[0].read_text())
    base = data["baseTimeNanoseconds"]
    rec = profiling.recorded_spans()["spans"]
    assert rec and data["romaSpans"] == {"recorded": len(rec), "dropped": 0}
    assert not any(s["name"] == "roma.test.before" for s in rec)  # trace() begins with an empty record
    events = [e for e in data["traceEvents"] if e.get("cat") in ("cpu_op", "user_annotation") and e["name"].startswith("roma.")]
    main = threading.get_native_id()
    for name in {s["name"] for s in rec if s["traced"]}:
        ours = sorted(s["start_ns"] for s in rec if s["name"] == name)
        theirs = sorted(base + 1000 * e["ts"] for e in events if e["name"] == name and e["tid"] == main)
        assert len(ours) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(ours, theirs)) < 1e6, name
    producer = [e for e in events if e["name"] == "roma.engine.prep"]
    assert len(producer) == 2 and all(e["tid"] != main for e in producer)
    for e in producer:
        s = next(s for s in rec if s["id"] == e["args"]["id"])
        assert e["args"]["unit"] == s["unit"] and abs(base + 1000 * e["ts"] - s["start_ns"]) < 1e3


def test_a_span_records_its_exception_and_closes():
    with _capture():
        with contextlib.suppress(ValueError), profiling.annotate("roma.test.outer"):
            with profiling.annotate("roma.test.inner"):
                raise ValueError("x")
        with profiling.annotate("roma.test.after"):
            pass
    outer, inner, after = (_spans(f"roma.test.{n}")[0] for n in ("outer", "inner", "after"))
    assert inner["parent"] == outer["id"] and after["parent"] is None and after["unit"] != outer["unit"]
