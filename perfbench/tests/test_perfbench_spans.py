"""The readers of the program's span metrics against a synthetic span
record: each is the mean a unit of what its spans recorded, and None where
no span of its names was recorded or the program records none."""
import pytest

from perfbench.lib import spans, spec

CELLS = {"match560_engine_b8": ("prep_ms.engine", "wait_ms.engine", "dispatch_ms.engine"),
         "match560_single": ("resize_ms.single", "net_host_ms.single", "kernel_host_ms.single"),
         "train560_b8_remat": ("to_device_ms.train", "forward_ms.train", "backward_ms.train", "optimizer_ms.train")}
READERS = {m: spec.load_cell(c).readers[m] for c, ms in CELLS.items() for m in ms}

_ids = iter(range(1, 10_000))


def span(name, unit, host_ms, device_ms=None, parent=None):
    return {"name": name, "id": next(_ids), "parent": parent, "unit": unit, "thread": 1, "start_ns": 0,
            "end_ns": int(host_ms * 1e6), "host_ms": host_ms, "device_ms": device_ms, "traced": True}


def two_units():
    """Two requests, batches or steps; unit 2 has twice unit 1's times."""
    rec = []
    for unit, k in ((1, 1.0), (2, 2.0)):
        rec += [span("roma.engine.prep", unit, 100 * k), span("roma.engine.wait", unit, 10 * k),
                span("roma.engine.dispatch", unit, 20 * k), span("roma.match.coarse", unit, 3 * k, 40 * k),
                span("roma.match.upsample", unit, 1 * k, 38 * k), span("roma.loader.to_device", unit, 30 * k),
                span("roma.train.forward", unit, 5 * k, 300 * k), span("roma.train.backward", unit, 6 * k, 600 * k),
                span("roma.train.optimizer", unit, 7 * k, 100 * k)]
        rec += [span("roma.match.resize", unit, 15 * k) for _ in range(4)]
        outer = span("roma.ops.fused_refiner_stack", unit, 0.3 * k)
        rec += [outer, span("roma.ops.warp_sample", unit, 0.05 * k, parent=outer["id"]),
                span("roma.ops.fused_attention_packed", unit, 0.2 * k)]
    return rec


EXPECTED = {"prep_ms.engine": 150.0, "wait_ms.engine": 15.0, "dispatch_ms.engine": 30.0, "resize_ms.single": 90.0,
            "net_host_ms.single": 6.0, "kernel_host_ms.single": 0.75, "to_device_ms.train": 45.0,
            "forward_ms.train": 450.0, "backward_ms.train": 900.0, "optimizer_ms.train": 150.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_the_mean_a_unit(monkeypatch, name):
    monkeypatch.setattr(spans, "record", two_units)
    assert READERS[name].read(None) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_none_without_its_spans(monkeypatch, name):
    monkeypatch.setattr(spans, "record", lambda: [])
    assert READERS[name].read(None) is None
    monkeypatch.setattr(spans, "record", lambda: [span("roma.other", 1, 1.0)])
    assert READERS[name].read(None) is None
    monkeypatch.setattr(spans, "record", lambda: None)  # a program without spans
    assert READERS[name].read(None) is None


def test_device_metrics_read_none_without_device_time(monkeypatch):
    monkeypatch.setattr(spans, "record", lambda: [span("roma.train.forward", 1, 5.0)])
    assert READERS["forward_ms.train"].read(None) is None


def test_a_program_without_a_span_record_reads_none(monkeypatch):
    from roma_tpu_torch.utils import profiling

    profiling.clear_spans()
    assert spans.record() == [] and READERS["prep_ms.engine"].read(None) is None
    monkeypatch.delattr(profiling, "recorded_spans")
    assert spans.record() is None
