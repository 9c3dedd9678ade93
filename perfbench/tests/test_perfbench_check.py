"""The check decides ``correct``: at RoMaConfig.tiny() on the CPU, a sound
run of each cell comes out correct, and the lower-precision control in the
program's place and each planted fault of the timed path come out not
correct. The limits here are the tiny size's (its sound runs read 1e-7 to
1e-4); the cells' own limits are set from readings on the card at their
sizes (PERF.md), which the card-marked tests repeat."""
import pytest
import torch

from perfbench.tests.tiny import run_tiny, tiny_cell

MATCH_LIMITS = {"dino_mlp0_rel_rms": 1e-5, "warp_p50_px": 1e-3, "warp_p99_px": 1e-3, "cert_p50": 1e-3,
                "kpt_p90_px": 1e-3}
TRAIN_LIMITS = {"dino_mlp0_rel_rms": 1e-5, "grad_gap_median": 1e-3, "change_gap_median": 1e-3, "loss_gap": 1e-4}
MATCH_BAD = [("control", None), ("fault", "shifted_warp"), ("fault", "scaled_cert")]
CASES = [
    ("match560_single", MATCH_LIMITS, MATCH_BAD),
    ("match560_engine_b8", {k: v for k, v in MATCH_LIMITS.items() if k != "kpt_p90_px"}, MATCH_BAD),
    ("train560_b8_remat", TRAIN_LIMITS, [("control", None), ("fault", "half_batch"), ("fault", "unchanged")]),
]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name, limits, _", CASES, ids=[c[0] for c in CASES])
def test_a_sound_run_is_correct(name, limits, _):
    r = run_tiny(tiny_cell(name, limits=limits), seed=3_000_000_019)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(limits)
    assert r["metrics"]["setup_s"]["value"] > 0 and r["attempted"] > 0


@pytest.mark.parametrize("name, limits, kind, fault",
                         [(n, lim, k, f) for n, lim, bad in CASES for k, f in bad],
                         ids=[f"{n}-{f or k}" for n, _, bad in CASES for k, f in bad])
def test_the_control_and_each_fault_are_caught(name, limits, kind, fault):
    r = run_tiny(tiny_cell(name, limits=limits), seed=41, control=kind == "control", fault=fault)
    assert not r["correct"], r["checks"]


def test_the_peaked_field_puts_each_cells_argmax_on_the_nearest_anchor():
    """The field both sides add to the coarse logits peaks, in each cell, at
    the anchor nearest the cell's target under the smooth warp, with a
    margin far above the seeded weights' own logit differences."""
    from perfbench.lib.matching import peaked_bias

    f = peaked_bias({"dino_patch": 14, "coarse_res": [560, 560], "cls_res": 64}, "cpu")
    assert f.shape == (1, 40, 40, 4096) and f.dtype == torch.float32
    lin = lambda n: torch.linspace(-1 + 1 / n, 1 - 1 / n, n, dtype=torch.float64)
    ys, xs = torch.meshgrid(lin(40), lin(40), indexing="ij")
    ay, ax = (g.reshape(-1) for g in torch.meshgrid(lin(64), lin(64), indexing="ij"))
    wx, wy = (0.9 * xs + 0.05).clamp(-0.98, 0.98), (0.9 * ys - 0.04).clamp(-0.98, 0.98)
    nearest = ((wx[..., None] - ax) ** 2 + (wy[..., None] - ay) ** 2).argmin(-1)
    assert torch.equal(f[0].argmax(-1), nearest)
    top2 = f[0].topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).median()) > 1.0  # a column of targets lies between two anchors
