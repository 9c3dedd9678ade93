"""The yardstick's arithmetic: launches a request and a step make, kernel
bounds, the profiler reading's union of intervals and idle gaps, the
kernels' roofline share from counters and a trace, and the operation count."""
import pytest

from perfbench.lib import costs, profile
from perfbench.tests.tiny import tiny_model

RELEASED = {"vgg_channels": [[64, 64], [128, 128], [256, 256, 256, 256], [512, 512, 512, 512]], "dino_dim": 1024,
            "dino_depth": 24, "dino_heads": 16, "dino_patch": 14, "gp_dim": 512, "cls_res": 64, "decoder_depth": 5,
            "decoder_heads": 8, "proj_out": [[16, 512], [8, 512], [4, 256], [2, 64], [1, 9]],
            "disp_emb": [[16, 128], [8, 64], [4, 32], [2, 16], [1, 6]],
            "corr_radius": [[16, 7], [8, 3], [4, 2], [2, 0], [1, 0]], "hidden_blocks": 8}


def counts(launches):
    out = {}
    for ln in launches:
        out[ln.kernel] = out.get(ln.kernel, 0) + 1
    return out


def test_launches_of_a_request_and_a_step():
    # the program's counts at released widths (PERF.md section 6: A 29, B 5, C 9, D 18 a request;
    # A 34 and E 5 a remat step)
    assert counts(costs.match_launches(RELEASED, 1, (560, 560), (864, 864))) == {"A": 29, "B": 5, "C": 9, "D": 18}
    assert counts(costs.train_launches(RELEASED, 8, (560, 560), True)) == {"A": 34, "E": 5}
    assert counts(costs.train_launches(RELEASED, 8, (560, 560), False)) == {"A": 29, "E": 5}


def test_bounds():
    a = costs.attention_fwd(2, 1601, 1024)
    assert a.bound_s() == pytest.approx(4 * 2 * 1601 * 1601 * 1024 / costs.PEAK_BF16)
    c = costs.warp_sample(2, 864, 864, 9)
    assert c.bound_s() == pytest.approx(max(2 * 864 * 864 * (2 * 9 * 2 + 8) / costs.HBM_BYTES_PER_S,
                                            8 * 2 * 864 * 864 * 9 / costs.PEAK_F32))


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert profile.union_length(iv) == 4.0
    assert profile.gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]


def test_reading_a_trace():
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    trace = {"traceEvents": [ev("kernel", "attn_fwd_k", 0, 100), ev("kernel", "gemm", 50, 100),
                             ev("gpu_memcpy", "Memcpy HtoD", 400, 100), ev("cpu_op", "aten::copy_", 150, 300),
                             ev("cpu_op", "aten::item", 160, 10)]}
    r = profile.read(trace, 500e-6)
    assert r["busy_s"] == pytest.approx(250e-6) and r["window_s"] == pytest.approx(500e-6)
    assert r["idle_gaps"][0] == ["aten::copy_", pytest.approx(250e-6)]
    assert profile.idle_share(r) == pytest.approx(50.0)
    assert r["device_ops"][0][0] in ("attn_fwd_k", "gemm", "Memcpy HtoD")


def test_kernels_roofline():
    per_unit = [costs.Launch("A", 0, 2e9)] * 2 + [costs.Launch("B", 3.35e6, 0)]
    a, b = 2e9 / costs.PEAK_BF16, 1e-6
    # two units traced: A at half its bound's speed, B at its bound
    records = {"traced_rounds": 2,
               "traced_launches": {"fused_attention_packed": 4, "local_correlation": 2, "warp_sample": 0},
               "trace": {"kernels": {"attn_fwd_x": [8 * a, 4], "local_corr_y": [2 * b, 2], "other": [5.0, 1]}}}
    assert costs.kernels_roofline(records, per_unit) == pytest.approx(100 * (4 * a + 2 * b) / (8 * a + 2 * b))


@pytest.mark.parametrize("change", ["fewer", "doubled", "one_more", "no_rounds", "not_traced"])
def test_kernels_roofline_refuses_counts_the_arithmetic_does_not_predict(change):
    """A launch count off the arithmetic (a miscount, a changed path, D's
    launches doubled) gives no share, never a rescaled or partial one."""
    per_unit = [costs.Launch("A", 0, 2e9)] * 2 + [costs.Launch("B", 3.35e6, 0)]
    records = {"traced_rounds": 2, "traced_launches": {"fused_attention_packed": 4, "local_correlation": 2},
               "trace": {"kernels": {"attn_fwd_x": [1e-3, 4], "local_corr_y": [1e-3, 2]}}}
    if change == "fewer":
        records["traced_launches"]["fused_attention_packed"] = 3
    elif change == "doubled":
        records["traced_launches"]["local_correlation"] = 4
    elif change == "one_more":
        records["traced_launches"]["fused_attention_packed"] = 5
    elif change == "no_rounds":
        del records["traced_rounds"]
    else:
        del records["trace"]["kernels"]["local_corr_y"]
    assert costs.kernels_roofline(records, per_unit) is None
    assert costs.kernels_roofline({"traced_rounds": 2, "traced_launches": {}, "trace": {"kernels": {}}},
                                  per_unit) is None


def test_the_operation_count_on_the_meta_device_is_the_real_one(tmp_path):
    """FlopCounterMode over the reference on the meta device counts what a
    real forward counts, and the count is cached."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import roma as R

    cfg = dict(tiny_model(), vit_gelu_tanh=False, coarse_res=[56, 56], upsample_res=[84, 84])
    got = costs.model_flops(cfg, "match", tmp_path)
    w = R.make_weights(cfg, 1, "cpu")
    ins = [torch.randn(1, h, h, 3) for h in (56, 56, 84, 84)]
    with FlopCounterMode(display=False) as counter:
        R.match(R.RoMaReference(cfg, w), *ins, (56, 56), (84, 84))
    assert got == counter.get_total_flops() > 0
    assert len(list(tmp_path.glob("flops_match_*.json"))) == 1 and costs.model_flops(cfg, "match", tmp_path) == got
