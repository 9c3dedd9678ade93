"""The card run's own checks, on the CPU: chip_smoke.py's spill gate on a
ptxas report, the bf16 ulp its bars count in, the planted faults of Kernels
D, B, C, J, I and H's plain versions breaking their ulp bar and K and L's
breaking the f32 bar, the edge shapes' coverage and the paths they take,
H's bound, L's expected rounding error, and where the build keeps the
report it reads."""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from roma_tpu_torch import _ext, ops  # noqa: E402

TC_KERNELS = [(kind, d) for kind in ("fwd", "bwd_dq", "bwd_dkv") for d in (64, 128)]


def ptxas_report(spilled=None, drop=None):
    """A report in ptxas's -v format for the six bf16 attention kernels and
    one other kernel; ``spilled`` spills 8 bytes, ``drop`` is left out."""
    lines = []
    for kind, d in TC_KERNELS + [("wide_block", 64)]:
        if (kind, d) == drop:
            continue
        name = (f"_ZN45_GLOBAL__N__e8eb3bcd_12_attention_cu_a12d772918attn_{kind}_tc_kernelILi{d}ELi8EEEvPK13"
                if kind != "wide_block" else "_Z16wide_block_kernelILi64EEvPKf")
        spill = 8 if (kind, d) == spilled else 0
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                  f"ptxas info    : Used {128 + d} registers, used 1 barriers, 400 bytes cmem[0]"]
    return "\n".join(lines)


def test_spill_gate_passes_a_clean_report(capsys):
    chip_smoke.check_tc_build(ptxas_report())
    out = capsys.readouterr().out
    assert "attn_bwd_dkv_tc_kernel<D=128>" in out and "256 registers" in out


@pytest.mark.parametrize("spilled", TC_KERNELS)
def test_spill_gate_fails_on_any_spill(spilled):
    with pytest.raises(chip_smoke.SmokeFailure, match="spill"):
        chip_smoke.check_tc_build(ptxas_report(spilled=spilled))


def test_spill_gate_fails_when_a_kernel_is_missing():
    with pytest.raises(chip_smoke.SmokeFailure, match="expected 6"):
        chip_smoke.check_tc_build(ptxas_report(drop=("fwd", 128)))


@pytest.mark.parametrize("x", [1.0, 2.6875, 24.5, 0.0390625, 0.0029296875])
def test_bf16_ulp_is_the_spacing_of_bfloat16(x):
    ulp = chip_smoke.bf16_ulp(x)
    base = torch.tensor(x, dtype=torch.bfloat16).float()
    assert base.item() == x  # the test values are bf16 values
    assert torch.tensor(x + ulp).bfloat16().float().item() == x + ulp
    assert torch.tensor(x + ulp / 4).bfloat16().float().item() == x


def test_ptxas_report_sits_beside_the_library():
    lib = _ext.library_path()
    rep = _ext.ptxas_path(lib)
    assert rep.parent == lib.parent and rep.name.startswith(lib.stem) and rep != lib


def _planted_cases():
    """(name, plain output, planted-fault output) of Kernels D and B at a
    small shape in bf16, on the CPU, drawn as chip_smoke.py draws them."""
    gen = torch.Generator().manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=gen).to(torch.bfloat16)
    blocks = chip_smoke.refiner_blocks(gen, device="cpu")
    x = rn(2, 20, 22, 24)
    out = [("fused_refiner_stack", ops.refiner_stack_reference(x, blocks), chip_smoke.refiner_edge_clamped(x, blocks))]
    for r in (2, 3, 7):
        f0, f1 = rn(2, 18, 17, 64), rn(2, 18, 17, 64)
        ys, xs = torch.meshgrid(torch.linspace(-1, 1, 18), torch.linspace(-1, 1, 17), indexing="ij")
        warp = torch.stack((xs, ys), -1)[None] + 0.05 * torch.randn(2, 18, 17, 2, generator=gen)
        out.append(("local_correlation", ops.local_correlation_reference(f0, f1, r, warp),
                    chip_smoke.corr_fractions_swapped(f0, f1, r, warp)))
    y = rn(2, 20, 22, 64)
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, 15), torch.linspace(-1, 1, 17), indexing="ij")
    flow = torch.stack((xs, ys), -1)[None] + 0.05 * torch.randn(2, 15, 17, 2, generator=gen)
    out.append(("warp_sample", ops.warp_sample_reference(y, flow), chip_smoke.warp_fractions_swapped(y, flow)))
    blocks = chip_smoke.refiner_blocks(gen, 40, 3, device="cpu")
    x = rn(2, 12, 14, 40)
    out.append(("hcw_refiner_block", ops.wide_refiner_stack_reference(x, blocks),
                chip_smoke.refiner_edge_clamped(x, blocks, round_w2=True)))
    blocks = chip_smoke.refiner_blocks(gen, 37, 3, device="cpu")
    x = rn(2, 12, 14, 37)
    out.append(("lane_refiner_block", ops.wide_refiner_stack_reference(x, blocks),
                chip_smoke.refiner_edge_clamped(x, blocks, round_w2=True)))
    blocks = chip_smoke.refiner_blocks(gen, device="cpu")
    x = rn(2, 21, 19, 24)
    out.append(("fused_refiner_stack_packed", ops.refiner_stack_reference(x, blocks),
                chip_smoke.refiner_edge_clamped(x, blocks)))
    return out


@pytest.mark.parametrize("i", range(8))
def test_planted_faults_break_the_ulp_bar(i, capsys):
    name, ref, wrong = _planted_cases()[i]
    chip_smoke.check_power(name, "cpu", "", ref, wrong, chip_smoke.FAULTS[name])
    assert f"bar {chip_smoke.ULP_BARS[name]}" in capsys.readouterr().out
    with pytest.raises(chip_smoke.SmokeFailure, match="disagrees"):
        chip_smoke.check_output(name, "cpu", torch.bfloat16, wrong, ref)
    chip_smoke.check_output(name, "cpu", torch.bfloat16, ref.clone(), ref)


def test_check_power_fails_a_fault_that_moves_nothing():
    name, ref, _ = _planted_cases()[0]
    with pytest.raises(chip_smoke.SmokeFailure, match="planted fault"):
        chip_smoke.check_power(name, "cpu", "", ref, ref.clone(), chip_smoke.FAULTS[name])


def test_the_ulp_bar_is_held_only_in_bf16():
    """float32 outputs keep F32_REL; a bf16 output one bar past the plain
    version fails, one ulp past it passes."""
    name, ref, _ = _planted_cases()[1]
    ulp = chip_smoke.bf16_ulp(ref.float().abs().max().item())
    bump = torch.zeros_like(ref, dtype=torch.float32)
    bump.view(-1)[0] = (chip_smoke.ULP_BARS[name] + 1) * ulp
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_output(name, "cpu", torch.bfloat16, ref.float() + bump, ref)
    chip_smoke.check_output(name, "cpu", torch.bfloat16, ref.float() + bump / (chip_smoke.ULP_BARS[name] + 1), ref)
    chip_smoke.check_output(name, "cpu", torch.float32, ref.float() + 1e-5, ref.float())


def test_planted_faults_change_only_what_they_name():
    """Where the fault cannot act the faulty plain version is the plain
    version: swapped fractions on a flow whose two fractions are equal, edge
    clamping on a map whose border is zero (the zero padding it replaces)."""
    gen = torch.Generator().manual_seed(4)
    y = torch.randn(1, 16, 16, 9, generator=gen)
    g = torch.linspace(-0.9, 0.9, 12)
    flow = torch.stack((g, g), -1).view(1, 1, 12, 2).expand(1, 12, 12, 2).contiguous()
    assert torch.equal(chip_smoke.warp_fractions_swapped(y, flow), ops.warp_sample_reference(y, flow))
    blocks = chip_smoke.refiner_blocks(gen, 16, 1, device="cpu")
    for blk in blocks:
        blk["db"].fill_(-1e3)  # every t is 0, so every output is the bias: padding cannot show
    x = torch.randn(1, 10, 11, 16, generator=gen).bfloat16()
    assert torch.equal(chip_smoke.refiner_edge_clamped(x, blocks, round_w2=True),
                       ops.wide_refiner_stack_reference(x, blocks))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c_edges_take_the_paths_they_name(dtype):
    from roma_tpu_torch.ops.warp_sample import warp_sample_checks

    for c, path in chip_smoke.C_EDGES.items():
        y = torch.zeros(2, 37, 45, c, dtype=dtype)
        assert warp_sample_checks("t", y, torch.zeros(2, 29, 53, 2))[-1] == path
    assert set(chip_smoke.C_EDGES.values()) == {"vector", "registers", "scalar"}


def test_j_edges_cover_what_they_claim():
    from roma_tpu_torch.ops.wide_refiner import wide_block_checks

    edges = chip_smoke.J_EDGES
    assert {1377, 1137, 569, 144, 37} <= {c for *_, c in edges}
    assert any(h < 5 for _, h, _, _ in edges) and any(b == 1 for b, *_ in edges)
    assert any(w % 32 and w % 2 for *_, w, _ in edges) and any(w % 32 and w % 2 == 0 for *_, w, _ in edges)
    for b, h, w, c in edges:
        x = torch.zeros(b, h, c, w, dtype=torch.bfloat16)
        assert wide_block_checks("t", x, chip_smoke.refiner_blocks(torch.Generator(), c, 1, device="cpu")[0],
                                 1)[-1] == "hcw_tc"


def test_planted_fault_of_h_changes_only_the_padding():
    """D and H's fault (edge clamping, w2 kept float32) is the plain version
    where every t is 0, and differs from it only near the border otherwise."""
    gen = torch.Generator().manual_seed(5)
    blocks = chip_smoke.refiner_blocks(gen, device="cpu")
    x = torch.randn(1, 20, 23, 24, generator=gen).bfloat16()
    ref, wrong = ops.refiner_stack_reference(x, blocks), chip_smoke.refiner_edge_clamped(x, blocks)
    moved = (ref.float() - wrong.float()).abs().amax(-1)[0]
    halo = 2 * len(blocks)  # a block's padding reaches 2 pixels further in
    assert moved.any() and not moved[halo:-halo, halo:-halo].any()
    for blk in blocks:
        blk["db"].fill_(-1e3)
    assert torch.equal(chip_smoke.refiner_edge_clamped(x, blocks), ops.refiner_stack_reference(x, blocks))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_i_edges_cover_what_they_claim(dtype):
    from roma_tpu_torch.ops.wide_refiner import wide_block_checks

    edges = chip_smoke.I_EDGES
    cs = {c for *_, c in edges}
    assert {1377, 1137, 569, 144} <= cs and any(c % 2 for c in cs) and any(c % 2 == 0 and c % 8 for c in cs)
    assert any(h < 5 for _, h, _, _ in edges) and any(b == 1 for b, *_ in edges)
    assert any(w % 32 for *_, w, _ in edges) and any(w % 64 and w > 64 for *_, w, _ in edges)
    for b, h, w, c in edges:
        x = torch.zeros(b, h, w, c, dtype=dtype)
        blk = chip_smoke.refiner_blocks(torch.Generator(), c, 1, device="cpu")[0]
        assert wide_block_checks("t", x, blk, 0)[-1] == ("nhwc_tc" if dtype == torch.bfloat16 else "tile8x8")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_h_edges_cover_what_they_claim(dtype):
    from roma_tpu_torch.ops.refiner_stack import C24_GROUP, packed_checks

    edges = chip_smoke.H_EDGES
    c24 = [(b, h, w) for b, h, w, c, k in edges if (c, k) == (24, 5)]
    assert any(w % _c24_tile_columns() for _, _, w in c24) and any(w < _c24_tile_columns() for _, _, w in c24)
    assert any(h < 5 for _, h, _ in c24) and any(b == 1 for b, _, _ in c24)
    assert any(c % 2 for *_, c, _ in edges) and any(c % 8 and c % 2 == 0 for *_, c, _ in edges)
    assert 5 % C24_GROUP  # the five blocks end on a partial group
    for b, h, w, c, k in edges:
        x = torch.zeros(b, h, w, c, dtype=dtype)
        path = packed_checks("t", x, chip_smoke.refiner_blocks(torch.Generator(), c, 5, k, device="cpu"))[-2]
        assert path == ("c24k5" if dtype == torch.bfloat16 and (c, k) == (24, 5) else "generic")


def _c24_tile_columns():
    """The c24k5 body's tile columns at the group size it runs:
    csrc/refiner_chain.cu tw_of(G) = 32 - 4 (G - 1)."""
    from roma_tpu_torch.ops.refiner_stack import C24_GROUP

    return 32 - 4 * (C24_GROUP - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_h_bound_counts_what_its_body_does(dtype):
    """packed_cost: the function reads x once and writes the output once,
    besides the weights; in bf16 on the c24k5 body the pointwise counts at
    the tensor cores' peak and the depthwise bounds it; in f32 both at the
    CUDA cores'."""
    blocks = chip_smoke.refiner_blocks(torch.Generator(), device="cpu")
    x = torch.zeros(2, 56, 56, 24, dtype=dtype)
    nbytes, pw, dwo, peak, path = chip_smoke.packed_cost(x, blocks)
    assert nbytes == 2 * x.numel() * x.element_size() + 9 * 4 * (25 * 24 + 24 * 24 + 48)
    assert (pw, dwo) == (2 * 9 * 2 * 56 * 56 * 576, 2 * 9 * 2 * 56 * 56 * 600)
    assert (path, peak) == (("c24k5", chip_smoke.PEAK_BF16_TENSOR) if dtype == torch.bfloat16
                            else ("generic", chip_smoke.PEAK_F32))
    case = chip_smoke.Case("fused_refiner_stack_packed", "t", None, None, bytes=nbytes, ops=pw, peak=peak,
                           f32_ops=dwo)
    if dtype == torch.bfloat16:
        assert case.ops_ms() == pytest.approx(1e3 * dwo / chip_smoke.PEAK_F32, rel=1e-12)


def _f32_planted(name):
    """(plain output, planted-fault output) of Kernel K or L on the CPU, on
    the tool's inputs at a few tiles."""
    from roma_tpu_torch.tools import bench_onehot_dots as bo

    gen = torch.Generator().manual_seed(6)
    if name == "onehot_dot":
        win, yl, fy = bo.e1_inputs(gen, nt=3, cww=8, device="cpu")
        return ops.onehot_dot_reference(win, yl, fy), chip_smoke.onehot_weights_swapped(win, yl, fy)
    args = bo.e2_inputs(gen, nt=5, b=2, hp=160, device="cpu")
    return (ops.window_sum_reference(*args, bo.WH, bo.NS),
            chip_smoke.window_shifted_down(*args, bo.WH, bo.NS))


@pytest.mark.parametrize("name", ["onehot_dot", "window_sum"])
def test_f32_planted_faults_break_the_f32_bar(name, capsys):
    ref, wrong = _f32_planted(name)
    chip_smoke.check_power(name, "cpu", "", ref, wrong, chip_smoke.FAULTS[name], f32=True)
    assert "x the f32 bar" in capsys.readouterr().out
    with pytest.raises(chip_smoke.SmokeFailure, match="disagrees"):
        chip_smoke.check_output(name, "cpu", torch.float32, wrong, ref)
    chip_smoke.check_output(name, "cpu", torch.float32, ref.clone(), ref)
    with pytest.raises(chip_smoke.SmokeFailure, match="planted fault"):
        chip_smoke.check_power(name, "cpu", "", ref, ref + 1e-6, chip_smoke.FAULTS[name], f32=True)


def test_k_edges_cover_what_they_claim():
    """One tile, WH of 5 and 300, both paths, T past one block's 4096
    queries with a partial last chunk, and yl of -1, WH - 1 and >= WH in
    every case."""
    from roma_tpu_torch.ops.onehot_dots import onehot_checks

    edges = chip_smoke.K_EDGES
    assert any(nt == 1 for nt, *_ in edges) and {5, 300} <= {wh for _, wh, _, _ in edges}
    assert any(t % 4 for *_, t in edges) and any(t > 4096 and t % 4096 and t % 4 == 0 for *_, t in edges)
    gen = torch.Generator().manual_seed(0)
    paths = set()
    for nt, wh, cww, t in edges:
        win, yl, fy = chip_smoke.k_edge_inputs(gen, nt, wh, cww, t, "cpu")
        path = onehot_checks("t", win, yl, fy, "f32")[4]
        assert path == ("vector" if t % 4 == 0 else "scalar")
        paths.add(path)
        assert {-1, wh - 1} <= set(yl.unique().tolist()) and (yl >= wh).any()
    assert paths == {"vector", "scalar"}


def test_l_edges_cover_what_they_claim():
    """XQC = 8, NS = 1, one tile, a row over one turn of a lane's 8 loads,
    and windows off the table on every side: NaN in the plain version at
    exactly the tiles check_onehot_edges expects."""
    from roma_tpu_torch.ops.onehot_dots import window_sum_checks

    edges = chip_smoke.L_EDGES
    assert any(xqc == 8 for _, _, _, xqc, *_ in edges) and any(ns == 1 for *_, ns, _ in edges)
    assert any(nt == 1 for *_, nt in edges) and any(xqc // 8 > 32 * 8 for _, _, _, xqc, *_ in edges)
    gen = torch.Generator().manual_seed(0)
    for b, hp, nj, xqc, wh, ns, nt in edges:
        tab, oy, jx, img = chip_smoke.l_edge_inputs(gen, b, hp, nj, xqc, wh, ns, nt, "cpu")
        window_sum_checks("t", tab, oy, jx, img, wh, ns)
        nan = torch.isnan(ops.window_sum_reference(tab, oy, jx, img, wh, ns)).view(-1)
        off = list(range(1, nt, 3)) if nt > 1 else []
        assert nan.nonzero().view(-1).tolist() == off
        if len(off) >= 4:  # every way out: past the bottom, past the last column, before row 0, no image
            k = torch.tensor(off[:4])
            assert oy[k[0]] > hp - wh and jx[k[1]] > nj - ns and oy[k[2]] < 0 and img[k[3]] == b


def _kernel_order_sums(x, wh, ns):
    """Kernel L's float32 additions in its order (csrc/onehot_dots.cu), in
    numpy: x (N, WH * NS, XQC) float32 -> (N,) tile sums. A row's lane l
    adds vectors l, l + 32, ... (8 values each) in order, 5 xor-shuffle
    levels join the lanes; a tile's lane l adds rows l, l + 32, ... in order,
    5 levels join them."""
    def lanes_then_tree(v, per_lane):  # v (..., n) terms, per_lane[l] the indices lane l adds in order
        m = max(map(len, per_lane))
        padded = np.concatenate((v, np.zeros(v.shape[:-1] + (1,), np.float32)), -1)
        idx = np.array([p + [v.shape[-1]] * (m - len(p)) for p in per_lane])  # (32, m)
        g = padded[..., idx]  # (..., 32, m)
        acc = np.zeros(g.shape[:-1], np.float32)
        for k in range(m):
            acc = (acc + g[..., k]).astype(np.float32)
        for o in (16, 8, 4, 2, 1):
            acc = (acc + acc[..., np.arange(32) ^ o]).astype(np.float32)
        return acc[..., 0]

    xqc = x.shape[-1]
    row_lanes = [[8 * vec + i for vec in range(lane, xqc // 8, 32) for i in range(8)] for lane in range(32)]
    rows = lanes_then_tree(x, row_lanes)  # (N, WH * NS)
    return lanes_then_tree(rows, [list(range(lane, wh * ns, 32)) for lane in range(32)])


def test_window_sum_rms_error_predicts_the_kernel_order():
    """The expected rounding error chip_smoke prints beside L's f32 bar is
    within 2x of the rms error of L's own summation order, simulated in
    float32 against a float64 sum, on random tiles."""
    rs = np.random.RandomState(0)
    wh, ns, xqc, n = 16, 3, 64, 3000
    x = rs.randn(n, wh * ns, xqc).astype(np.float32)
    err = _kernel_order_sums(x, wh, ns).astype(np.float64) - x.astype(np.float64).sum((1, 2))
    rms = math.sqrt(float(np.mean(err ** 2)))
    est = chip_smoke.window_sum_rms_error(xqc, wh, ns, float(np.mean(x.astype(np.float64) ** 2)))
    assert 0.5 < rms / est < 2.0, (rms, est)


@pytest.mark.parametrize("density", [0.005, 0.5])
def test_compact_fault_breaks_the_exact_check(density, capsys):
    """Kernel F's planted fault (every rank one too high) changes slots at
    chip_smoke's v2 density extremes, and an unchanged copy fails
    check_power."""
    gen = torch.Generator().manual_seed(5)
    miss = torch.rand(64, 1, 256, generator=gen) < density
    ref = ops.compact_miss_reference(miss, 256, 32)
    wrong = chip_smoke.compact_rank_off_by_one(miss, 256, 32)
    assert torch.equal(wrong[:, 1:], ref[:, :-1]) and bool((wrong[:, 0] == 256).all())
    chip_smoke.check_power("compact_miss", "cpu", "", ref, wrong, chip_smoke.FAULTS["compact_miss"], exact=True)
    assert "exact check" in capsys.readouterr().out
    with pytest.raises(chip_smoke.SmokeFailure, match="planted fault"):
        chip_smoke.check_power("compact_miss", "cpu", "", ref, ref.clone(), chip_smoke.FAULTS["compact_miss"],
                               exact=True)


def test_compact_edges_cover_what_they_claim():
    """Each COMPACT_EDGES case takes the path it names, and each kind of
    flags sets what it says."""
    from roma_tpu_torch.ops import window_util as wu

    gen = torch.Generator().manual_seed(6)
    assert {p for *_, p in chip_smoke.COMPACT_EDGES} == set(wu.PATH_CODES)
    for bnt, t, kf, path in chip_smoke.COMPACT_EDGES:
        counts = {}
        for kind in chip_smoke.COMPACT_KINDS:
            miss = chip_smoke.edge_miss(kind, bnt, t, kf, gen, device="cpu")
            assert miss.shape == (bnt, 1, t) and miss.dtype == torch.bool
            assert wu.compact_checks(miss, t, kf) == path
            counts[kind] = miss.sum(-1).flatten()
            if kind == "past_kf":
                assert not miss[..., :kf].any()
        assert (counts["none"] == 0).all() and (counts["all"] == t).all()
        assert (counts["exactly_kf"] == min(kf, t)).all() and (counts["past_kf"] == min(kf, max(t - kf, 0))).all()


def test_tiny_flip_comparison_sets_aside_only_near_flips():
    """compare_beside_flips, the card run's comparison of Tiny RoMa's
    approximate path: a difference next to a flipped argmax cell is set
    aside, a planted fault elsewhere breaks the bar, and the share set aside
    is that of the flipped cells' neighbourhoods. Planted: neighbourhoods
    over TINY_ASIDE of the pixels, more flips than TINY_FLIPS, and flips
    that leave nothing to compare all fail."""
    rs = np.random.RandomState(0)
    want = torch.from_numpy(rs.uniform(-1, 1, (2, 88, 120, 4)).astype(np.float32))
    flipped = torch.zeros(2, 11, 15, dtype=torch.bool)
    got = want + 1e-5
    clean = chip_smoke.compare_beside_flips(got, want, flipped, radius=2)
    assert clean["flipped"] == 0 and clean["aside"] == 0 and clean["excess"] <= 0 and clean["ok"]
    flipped[1, 5, 7] = True
    near = got.clone()
    near[1, 5 * 8:6 * 8, 7 * 8:8 * 8] += 0.3  # the flipped cell's own pixels
    out = chip_smoke.compare_beside_flips(near, want, flipped, radius=1)
    assert out["flipped"] == 1 and out["excess"] <= 0 and out["ok"]
    assert out["aside"] == pytest.approx(3 * 3 * 64 / (2 * 88 * 120))
    wide = chip_smoke.compare_beside_flips(near, want, flipped, radius=2)
    assert wide["aside"] == pytest.approx(5 * 5 * 64 / (2 * 88 * 120)) and wide["aside"] > chip_smoke.TINY_ASIDE
    assert wide["excess"] <= 0 and not wide["ok"]
    far = near.clone()
    far[0, 80, 3, 2] += 0.01  # a planted fault in the other image
    out = chip_smoke.compare_beside_flips(far, want, flipped, radius=1)
    assert out["excess"] > 0 and not out["ok"]
    assert chip_smoke.compare_beside_flips(got[..., 0], want[..., 0], flipped, radius=1)["ok"]
    many = torch.zeros_like(flipped)
    many[0, 0, :4] = True  # 4 of 330 cells, over TINY_FLIPS; their neighbourhoods stay small
    out = chip_smoke.compare_beside_flips(got, want, many, radius=0)
    assert out["aside"] <= chip_smoke.TINY_ASIDE and out["excess"] <= 0 and not out["ok"]
    everywhere = chip_smoke.compare_beside_flips(got + 1.0, want, torch.ones_like(flipped), radius=0)
    assert everywhere["aside"] == 1 and everywhere["excess"] == math.inf and not everywhere["ok"]
