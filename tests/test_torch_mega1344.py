"""roma_outdoor at Mega-1500's 672 -> 1344 canvas (the benchmark's
``roma_outdoor_672to1344`` and its cell ``match1344_engine_b4``), on the CPU
at RoMaConfig.tiny() widths with seeded weights: the port's match against
the plain reference at the refinement ratio of 2, with and without the
peaked anchor-logit field; MatchEngine at batch 4 against per-pair match;
the cell's files, its launch arithmetic and its per-layer readers."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from PIL import Image

from perfbench.lib import costs, matching, spans, spec, traffic
from perfbench.reference import roma as R
from perfbench.tests.tiny import tiny_model
from roma_tpu_torch.models.roma import RegressionMatcher
from roma_tpu_torch.serving import MatchEngine
from torch_port_fixtures import one_thread  # noqa: F401 (autouse: one torch thread)

CELL = "match1344_engine_b4"
SPAN_METRICS = {"vgg_ms.engine": "roma.net.vgg", "dinov2_ms.engine": "roma.net.dinov2",
                "gm_ms.engine": "roma.net.gm", "refine_ms.engine": "roma.net.refine.s8"}
# the batch engine's accepted metrics, each read from the configuration, the
# mix or the trace, so the same readers serve this cell
ENGINE_METRICS = {"engine_kernels_roofline", "idle_share.engine", "mfu.engine", "prep_ms.engine", "wait_ms.engine",
                  "dispatch_ms.engine"}


@pytest.fixture(scope="module")
def cfg():
    """The configuration's model at tiny widths; its exact GELU kept."""
    model = spec.load_cell(CELL).config["model"]
    return dict(tiny_model(), vit_gelu_tanh=model["vit_gelu_tanh"])


def port_matcher(cfg, weights, coarse, up):
    from roma_tpu_torch.models.zoo import build_net

    net = build_net(matching.port_config({"model": cfg}, False), "cpu")
    net.load_state_dict(weights)
    return RegressionMatcher(net.eval(), h=coarse, w=coarse, upsample_res=(up, up))


def pair(seed: int, hw=(90, 120)):
    rs = np.random.RandomState(seed)
    a = Image.fromarray((traffic.texture(rs, *hw) * 255).astype(np.uint8))
    return a, a.rotate(7, resample=Image.BICUBIC)


@pytest.mark.parametrize("pinned", [False, True], ids=["free", "pinned"])
@pytest.mark.parametrize("coarse, up", [(56, 112), (84, 168)], ids=["56to112", "84to168"])
def test_the_match_agrees_at_twice_the_canvas(cfg, coarse, up, pinned):
    """The refinement canvas twice the coarse one, as 672 -> 1344: the
    upsample pass's refiners at scale_factor up / 560, against the plain
    float32 reference (``test_the_match_agrees``'s atol)."""
    bias = matching.peaked_bias(dict(cfg, coarse_res=[coarse, coarse]), "cpu") if pinned else None
    w = R.make_weights(cfg, 7, "cpu")
    a, b = pair(1)
    warp, cert = port_matcher(cfg, w, coarse, up).match(a, b, gm_logit_bias=bias)
    assert tuple(warp.shape) == (up, 2 * up, 4)
    hws = ((coarse, coarse), (up, up))
    ins = [R.prepare(p, hw, "cpu") for hw in hws for p in (a, b)]
    rw, rc = R.match(R.RoMaReference(cfg, w), *ins, *hws, gm_logit_bias=bias)
    assert torch.allclose(warp, rw[0], atol=1e-5, rtol=0) and torch.allclose(cert, rc[0], atol=1e-5, rtol=0)


def test_the_engine_at_batch_4_equals_per_pair_match(cfg, tmp_path):
    """Five pairs of four sizes, landscape and portrait, as the cell's mix
    has them: one full batch of 4 and one padded; each result in order and
    equal to ``match`` on the same files, with the cell's peaked field."""
    w = R.make_weights(cfg, 8, "cpu")
    m = port_matcher(cfg, w, 56, 112)
    m.match = functools.partial(m.match, gm_logit_bias=matching.peaked_bias(dict(cfg, coarse_res=[56, 56]), "cpu"))
    files = []
    for i, hw in enumerate(((80, 120), (90, 120), (120, 80), (120, 90), (80, 120))):
        paths = (str(tmp_path / f"{i}_A.png"), str(tmp_path / f"{i}_B.png"))
        for im, p in zip(pair(10 + i, hw), paths):
            im.save(p)
        files.append(paths)
    results = list(MatchEngine(m, batch_size=4).match_paths(files))
    assert [r.index for r in results] == list(range(len(files)))
    for r, (pa, pb) in zip(results, files):
        warp, cert = m.match(pa, pb)
        assert torch.allclose(r.warp, warp, atol=1e-5, rtol=0) and torch.allclose(r.certainty, cert, atol=1e-5, rtol=0)


def test_the_cell_loads_its_files():
    cell = spec.load_cell(CELL)
    model = cell.config["model"]
    assert cell.config_name == "roma_outdoor_672to1344" and cell.chips == 1 and cell.config["reduced"] == []
    assert model["coarse_res"] == [672, 672] and model["upsample_res"] == [1344, 1344]
    assert model["vit_gelu_tanh"] is False and cell.config["dtype"] == "bfloat16"
    assert cell.config["reference"] == "perfbench/reference/roma.py"
    assert cell.mix["driver"] == "engine" and cell.mix["batch_size"] == 4 and cell.mix["keep"] == 4
    assert cell.driver.__name__.endswith("engine")
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "peak_mem_gib", "setup_s"}
    assert set(cell.readers) == set(SPAN_METRICS) | ENGINE_METRICS
    assert set(cell.mix["limits"]) >= {"dino_mlp0_rel_rms", "warp_p50_px", "cert_p50"}
    released = spec.load_cell("match560_engine_b8").config["model"]
    changed = {k for k in model if model[k] != released[k]}
    assert changed == {"coarse_res", "upsample_res", "vit_gelu_tanh"}  # the published widths, unchanged


def test_the_launches_of_a_batch_at_672_to_1344():
    m = spec.load_cell(CELL).config["model"]
    launches = costs.match_launches(m, 4, m["coarse_res"], m["upsample_res"])
    counts = {k: sum(ln.kernel == k for ln in launches) for k in "ABCD"}
    assert counts == {"A": 29, "B": 5, "C": 9, "D": 18}
    # A over 2 x 4 images of 48^2 + 1 tokens, B's and C's largest maps at 336^2 and 1344^2, D's at 1344^2
    a = [ln for ln in launches if ln.kernel == "A"]
    assert a[0] == costs.attention_fwd(8, 2305, 1024) and a[-1] == costs.attention_fwd(8, 2304, 1024)
    assert costs.local_corr(8, 336, 336, 256, 2) in launches and costs.warp_sample(8, 1344, 1344, 9) in launches
    assert launches[-1] == costs.refiner_block(8, 1344, 1344, 24)


_ids = iter(range(1, 10_000))


def span(name, unit, device_ms):
    return {"name": name, "id": next(_ids), "parent": None, "unit": unit, "thread": 1, "start_ns": 0,
            "end_ns": 1, "host_ms": 1e-6, "device_ms": device_ms, "traced": True}


def two_batches():
    """Two batches, the second with twice the first's device times: VGG
    twice a batch, DINOv2 and the global match once, refiners at nine
    scale calls, and the pass spans around them."""
    rec = []
    for unit, k in ((1, 1.0), (2, 2.0)):
        rec += [span("roma.match.coarse", unit, 500 * k), span("roma.match.upsample", unit, 400 * k)]
        rec += [span("roma.net.vgg", unit, 30 * k), span("roma.net.vgg", unit, 70 * k),
                span("roma.net.dinov2", unit, 60 * k), span("roma.net.gm", unit, 20 * k)]
        rec += [span(f"roma.net.refine.s{s}", unit, 5 * k) for s in (16, 8, 4, 2, 1, 8, 4, 2, 1)]
    return rec


EXPECTED = {"vgg_ms.engine": 150.0, "dinov2_ms.engine": 90.0, "gm_ms.engine": 30.0, "refine_ms.engine": 67.5}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_each_module_reader_is_the_mean_a_batch(monkeypatch, name):
    reader = spec.load_cell(CELL).readers[name]
    monkeypatch.setattr(spans, "record", two_batches)
    assert reader.read(None) == pytest.approx(EXPECTED[name])
    assert spec.load_cell("match560_engine_b8").readers[name].read(None) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_each_module_reader_reads_none_without_its_spans(monkeypatch, name):
    """A program older than the module spans (the pass spans alone), a run
    that recorded none, a program with no span record, and spans without
    device time all read None."""
    reader = spec.load_cell(CELL).readers[name]
    for rec in ([span("roma.match.coarse", 1, 5.0)], [], None, [span(SPAN_METRICS[name], 1, None)]):
        monkeypatch.setattr(spans, "record", lambda rec=rec: rec)
        assert reader.read(None) is None


class _Run:
    def __init__(self, records):
        cell = spec.load_cell(CELL)
        self.cfg, self.mix, self.records = cell.config, cell.mix, records


def _traced(rounds: int, extra_d: int = 0) -> dict:
    per = costs.match_launches(_Run({}).cfg["model"], 4, [672, 672], [1344, 1344])
    took = {k: 2 * sum(ln.bound_s() for ln in per if ln.kernel == k) * rounds for k in "ABCD"}
    return {"traced_rounds": rounds,
            "traced_launches": {"fused_attention_packed": 29 * rounds, "local_correlation": 5 * rounds,
                                "warp_sample": 9 * rounds, "fused_refiner_stack": 18 * rounds + extra_d},
            "trace": {"kernels": {"attn_fwd_bf16": [took["A"], 29 * rounds], "local_corr_vec": [took["B"], 5 * rounds],
                                  "warp_vec": [took["C"], 9 * rounds], "refiner_block_c24": [took["D"], 18 * rounds],
                                  "cudnn_conv": [1.0, 7]}}}


def test_the_roofline_reader_reads_a_batch_s_launches():
    """The engine's roofline reader at this cell's canvases and batch: every
    kernel at twice its least time reads 50%; a count off the arithmetic, or
    no traced batch, reads None."""
    reader = spec.load_cell(CELL).readers["engine_kernels_roofline"]
    assert reader.read(_Run(_traced(4))) == pytest.approx(50.0)
    assert reader.read(_Run(_traced(4, extra_d=9))) is None
    assert reader.read(_Run({})) is None
