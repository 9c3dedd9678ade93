"""Kernels K and L's plain versions (roma_tpu_torch.ops.onehot_dot_f32 /
onehot_dot_2bf16 / window_sum on CPU tensors) against the Pallas bodies of
tools/bench_onehot_dots.py in interpret mode, at small tile counts with the
module's own window constants; L's two-phase summation (each table row
once, then each tile's row sums) against both; the wrappers' argument
checks and the launch plans they return; and the port's tools at a tiny
size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from roma_tpu_torch.ops import (
    onehot_dot,
    onehot_dot_2bf16,
    onehot_dot_f32,
    onehot_dot_reference,
    window_sum,
    window_sum_reference,
)
from roma_tpu_torch.ops.onehot_dots import K_MAX_T, K_MAX_WH, onehot_checks, window_rows, window_sum_checks
from roma_tpu_torch.tools import bench_hcw_refiner, bench_onehot_dots
from tools import bench_onehot_dots as jax_tool


def _jax_dot(kern, win, yl, fy):
    """tools/bench_onehot_dots.py:run_dot's pallas_call at win's tile count."""
    nt, wh, cww = win.shape
    t = jax_tool.NQ * jax_tool.QS
    return pl.pallas_call(
        kern,
        grid=(nt,),
        in_specs=[pl.BlockSpec((1, wh, cww), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 1, t), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 1, t), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, t), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nt, 1, t), jnp.float32),
        interpret=True,
    )(win, yl, fy)


@pytest.mark.parametrize("form", ["f32", "2bf16"])
def test_onehot_dot_matches_pallas_interpret(form):
    wh, t = jax_tool.WH, jax_tool.NQ * jax_tool.QS
    rs = np.random.RandomState(0)
    win = rs.randn(2, wh, 16).astype(np.float32)
    # rows -1 and WH - 1 put one tap outside the window: it contributes 0
    yl = rs.randint(-1, wh, (2, 1, t)).astype(np.int32)
    fy = rs.rand(2, 1, t).astype(np.float32)
    kern = jax_tool._kern_f32 if form == "f32" else jax_tool._kern_2bf16
    ref = np.asarray(_jax_dot(kern, jnp.asarray(win, jnp.bfloat16), jnp.asarray(yl), jnp.asarray(fy)))
    entry = onehot_dot_f32 if form == "f32" else onehot_dot_2bf16
    before = onehot_dot.launches
    got = entry(torch.from_numpy(win).bfloat16(), torch.from_numpy(yl), torch.from_numpy(fy))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, t)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert onehot_dot.launches == before == 0
    with pytest.raises(ValueError):
        onehot_dot(torch.from_numpy(win).bfloat16(), torch.from_numpy(yl), torch.from_numpy(fy), "f16")


def _window_inputs():
    """A (2, 160, 8, XQC) table and three in-table windows of the JAX tool's
    (WH, NS), from numpy."""
    wh, ns, xqc = jax_tool.WH, jax_tool.NS, jax_tool.XQC
    rs = np.random.RandomState(1)
    tab = rs.randn(2, 160, 8, xqc).astype(np.float32)
    oy = rs.randint(0, 160 - wh, 3).astype(np.int32)
    jx = rs.randint(0, 8 - ns, 3).astype(np.int32)
    img = np.array([0, 1, 1], np.int32)
    return tab, oy, jx, img


def _pallas_window_sums(tab, oy, jx, img):
    """tools/bench_onehot_dots.py:_dma_kernel in interpret mode."""
    wh, ns, xqc = jax_tool.WH, jax_tool.NS, jax_tool.XQC
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(len(oy),), in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 1), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((wh, ns * xqc), jnp.bfloat16), pltpu.SemaphoreType.DMA],
    )
    return np.asarray(pl.pallas_call(jax_tool._dma_kernel, grid_spec=grid_spec,
                                     out_shape=jax.ShapeDtypeStruct((len(oy), 1), jnp.float32), interpret=True)(
        jnp.asarray(oy), jnp.asarray(jx), jnp.asarray(img), jnp.asarray(tab, jnp.bfloat16)))


def test_window_sum_matches_pallas_interpret():
    wh, ns = jax_tool.WH, jax_tool.NS
    tab, oy, jx, img = _window_inputs()
    ref = _pallas_window_sums(tab, oy, jx, img)
    ttab = torch.from_numpy(tab).bfloat16()
    got = window_sum(ttab, *(torch.from_numpy(a) for a in (oy, jx, img)), wh, ns)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1)
    # relative to the largest sum: a sum near 0 keeps the other sums' rounding
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert window_sum.launches == 0
    # a window that leaves the table has no sum
    bad = window_sum_reference(ttab, *(torch.tensor([v], dtype=torch.int32) for v in (160 - wh + 1, 0, 0)), wh, ns)
    assert torch.isnan(bad).all()


def two_phase_window_sum(tab, oy, jx, img, wh, ns):
    """Kernel L's summation in plain PyTorch: every table row's float32 sum
    once (phase 1), then each tile's WH x NS row sums (phase 2); NaN for a
    window that leaves the table."""
    b, hp, nj, _ = tab.shape
    rowsum = tab.float().sum(-1).reshape(-1)
    ok = (img >= 0) & (img < b) & (oy >= 0) & (oy + wh <= hp) & (jx >= 0) & (jx + ns <= nj)
    rows = window_rows(tab, oy, jx, img, wh, ns).clamp(0, rowsum.numel() - 1)
    total = rowsum[rows].sum((1, 2))
    return torch.where(ok, total, torch.full_like(total, float("nan")))[:, None]


def test_two_phase_sum_matches_the_plain_version_and_pallas():
    """L sums each table row once and then each tile's row sums: another
    order than the plain version's and the TPU kernel's window sums, within
    the f32 bar the card holds L to (1e-4 of the largest sum)."""
    wh, ns = jax_tool.WH, jax_tool.NS
    tab, oy, jx, img = _window_inputs()
    pallas = _pallas_window_sums(tab, oy, jx, img)
    args = (torch.from_numpy(tab).bfloat16(), *(torch.from_numpy(a) for a in (oy, jx, img)))
    got, ref = two_phase_window_sum(*args, wh, ns), window_sum_reference(*args, wh, ns)
    bar = 1e-4 * max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= bar
    assert np.abs(got.numpy() - pallas).max() <= bar
    # off-table windows: NaN in both
    off = [torch.tensor(v, dtype=torch.int32) for v in ([160 - wh + 1, 0, -1, 0], [0, 8 - ns + 1, 0, 0],
                                                        [0, 0, 0, 2])]
    assert torch.isnan(two_phase_window_sum(args[0], *off, wh, ns)).all()
    assert torch.isnan(window_sum_reference(args[0], *off, wh, ns)).all()


def _k_args(nt=2, wh=16, cww=5, t=64, yl_off=0, fy_off=0):
    """win, yl, fy for onehot_checks; yl and fy views whose bases lie
    ``yl_off`` / ``fy_off`` elements into their storage."""
    win = torch.zeros(nt, wh, cww, dtype=torch.bfloat16)
    yl = torch.zeros(nt * t + 8, dtype=torch.int32)[yl_off:yl_off + nt * t].view(nt, 1, t)
    fy = torch.zeros(nt * t + 8)[fy_off:fy_off + nt * t].view(nt, 1, t)
    return win, yl, fy


def _aligned(t):
    return t.data_ptr() % 16 == 0


@pytest.mark.parametrize("case", ["form", "win dtype", "yl dtype", "fy dtype", "yl 2-D", "fy length", "tiles",
                                  "strided yl", "WH over the cap", "T over the cap"])
def test_onehot_checks_refuse(case):
    win, yl, fy = _k_args()
    form = "f32"
    if case == "form":
        form = "f16"
    elif case == "win dtype":
        win = win.float()
    elif case == "yl dtype":
        yl = yl.long()
    elif case == "fy dtype":
        fy = fy.double()
    elif case == "yl 2-D":
        yl = yl.view(2, 64)
    elif case == "fy length":
        fy = fy[..., :60]
    elif case == "tiles":
        win = win[:1]
    elif case == "strided yl":
        yl = torch.zeros(2, 1, 128, dtype=torch.int32)[..., ::2]
    elif case == "WH over the cap":
        win = torch.zeros(2, K_MAX_WH + 1, 1, dtype=torch.bfloat16)
    else:  # one past the last T whose chunk indices stay 32-bit ints; meta tensors hold no storage
        win = torch.empty(1, 16, 1, dtype=torch.bfloat16, device="meta")
        yl = torch.empty(1, 1, K_MAX_T + 1, dtype=torch.int32, device="meta")
        fy = torch.empty(1, 1, K_MAX_T + 1, device="meta")
        assert onehot_checks("t", win, yl[..., :-1], fy[..., :-1], form)[3] == K_MAX_T
    with pytest.raises(ValueError):
        onehot_checks("t", win, yl, fy, form)


def test_onehot_checks_refuse_a_gradient():
    win, yl, fy = _k_args()
    with pytest.raises(RuntimeError, match="forward-only"):
        onehot_checks("t", win.requires_grad_(), yl, fy, "2bf16")


@pytest.mark.parametrize("nt, wh, cww, t, yl_off, fy_off, path", [
    (2, 16, 5, 64, 0, 0, "vector"),
    (3, 128, 1728, 4096, 0, 0, "vector"),
    (1, K_MAX_WH, 1, 8, 0, 0, "vector"),
    (2, 5, 3, 6, 0, 0, "scalar"),
    # the scalar path takes any base, so a misaligned yl or fy takes it at T % 4 == 0 too
    (2, 300, 7, 333, 1, 0, "scalar"),
    (2, 16, 5, 64, 1, 0, "scalar"),
    (2, 16, 5, 64, 0, 2, "scalar"),
])
def test_onehot_checks_plan_the_path(nt, wh, cww, t, yl_off, fy_off, path):
    win, yl, fy = _k_args(nt, wh, cww, t, yl_off=yl_off, fy_off=fy_off)
    assert _aligned(torch.zeros(8)) and _aligned(torch.zeros(8, dtype=torch.int32))
    for form in ("f32", "2bf16"):
        assert onehot_checks("t", win, yl, fy, form) == (nt, wh, cww, t, path, 4 * wh)


def _l_args(b=2, hp=20, nj=4, xqc=16, nt=5, tab_off=0):
    tab = torch.zeros(b * hp * nj * xqc + 8, dtype=torch.bfloat16)[tab_off:tab_off + b * hp * nj * xqc]
    idx = [torch.zeros(nt, dtype=torch.int32) for _ in range(3)]
    return (tab.view(b, hp, nj, xqc), *idx)


@pytest.mark.parametrize("case", ["tab dtype", "XQC % 8", "tab 3-D", "oy dtype", "oy 2-D", "jx length", "WH 0",
                                  "NS 0", "WH not an int", "strided tab", "tab base + 2 bytes"])
def test_window_sum_checks_refuse(case):
    tab, oy, jx, img = _l_args()
    wh, ns = 8, 2
    if case == "tab dtype":
        tab = tab.float()
    elif case == "XQC % 8":
        tab = torch.zeros(2, 20, 4, 12, dtype=torch.bfloat16)
    elif case == "tab 3-D":
        tab = tab[0]
    elif case == "oy dtype":
        oy = oy.long()
    elif case == "oy 2-D":
        oy = oy[:, None]
    elif case == "jx length":
        jx = jx[:4]
    elif case == "WH 0":
        wh = 0
    elif case == "NS 0":
        ns = 0
    elif case == "WH not an int":
        wh = 8.0
    elif case == "strided tab":
        tab = torch.zeros(2, 20, 4, 32, dtype=torch.bfloat16)[..., ::2]
    else:
        tab, oy, jx, img = _l_args(tab_off=1)
    with pytest.raises(ValueError):
        window_sum_checks("t", tab, oy, jx, img, wh, ns)


def test_window_sum_checks_refuse_a_gradient():
    tab, oy, jx, img = _l_args()
    with pytest.raises(RuntimeError, match="forward-only"):
        window_sum_checks("t", tab.requires_grad_(), oy, jx, img, 8, 2)


@pytest.mark.parametrize("b, hp, nj, xqc, nt", [(2, 20, 4, 16, 5), (16, 928, 8, 1152, 3024), (1, 3, 1, 8, 1)])
def test_window_sum_checks_plan_the_scratch(b, hp, nj, xqc, nt):
    tab, oy, jx, img = _l_args(b, hp, nj, xqc, nt) if b * hp * nj * xqc < 2**20 else (
        torch.empty(b, hp, nj, xqc, dtype=torch.bfloat16), *_l_args(nt=nt)[1:])
    assert window_sum_checks("t", tab, oy, jx, img, 3, 2) == (b, hp, nj, xqc, nt, b * hp * nj)


def test_onehot_tool_runs_tiny_on_the_cpu(capsys):
    r1 = bench_onehot_dots.e1(nt=2, cww=16, device="cpu")
    r2 = bench_onehot_dots.e2(nt=3, b=2, hp=160, device="cpu")
    out = capsys.readouterr().out
    assert out.count("not measured (cpu)") == 4
    win, yl, fy = bench_onehot_dots.e1_inputs(torch.Generator().manual_seed(0), 2, 16, "cpu")
    for form in ("f32", "2bf16"):
        got, ms = r1[form]
        assert ms is None and torch.equal(got, onehot_dot_reference(win, yl, fy))
    sums, ms = r2["sums"]
    assert ms is None and r2["gather_ms"] is None
    tab = r2["inputs"][0]
    rows = window_rows(*r2["inputs"], bench_onehot_dots.WH, bench_onehot_dots.NS).unique()
    assert r2["covered_bytes"] == rows.numel() * tab.shape[-1] * 2 < tab.numel() * 2
    assert torch.equal(sums, window_sum_reference(*r2["inputs"], bench_onehot_dots.WH, bench_onehot_dots.NS))
    assert bool(torch.isfinite(sums).all()) and tuple(sums.shape) == (3, 1)


def test_hcw_tool_runs_tiny_on_the_cpu(capsys):
    res = bench_hcw_refiner.run_shape("tiny", 10, 40, batch=1, device="cpu")
    line = capsys.readouterr().out
    assert line.startswith("tiny   10^2 C=40 B=1:") and line.count("not measured (cpu)") == 3
    assert all(v is None for v in res["ms"].values())
    lane, hcw, model = (res["outs"][k].float() for k in ("lane", "hcw", "model"))
    # the same folded stack, two layouts; the bf16 modules round their weights
    assert (lane - hcw).abs().max().item() <= 2 ** -7 * lane.abs().max().item()
    assert (lane - model).abs().max().item() <= 2e-2 * model.abs().max().item()


def test_tools_arguments():
    assert bench_hcw_refiner.parse_args([]).batch == bench_hcw_refiner.B == 16
    assert bench_hcw_refiner.parse_args(["--batch", "2"]).batch == 2
    for argv in (["--batch", "0"], ["--batch", "x"], ["--unknown"]):
        with pytest.raises(SystemExit) as e:
            bench_hcw_refiner.parse_args(argv)
        assert e.value.code == 2
    with pytest.raises(SystemExit):
        bench_onehot_dots.main(["--batch", "2"])
    if not torch.cuda.is_available():  # a timed run needs the card
        for main in (bench_hcw_refiner.main, bench_onehot_dots.main):
            with pytest.raises(SystemExit, match="CUDA card"):
                main([])
