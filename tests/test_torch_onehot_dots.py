"""Kernels K and L's plain versions (roma_tpu_torch.ops.onehot_dot_f32 /
onehot_dot_2bf16 / window_sum on CPU tensors) against the Pallas bodies of
tools/bench_onehot_dots.py in interpret mode, at small tile counts with the
module's own window constants; and the port's tools at a tiny size."""
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


def test_window_sum_matches_pallas_interpret():
    wh, ns, xqc = jax_tool.WH, jax_tool.NS, jax_tool.XQC
    rs = np.random.RandomState(1)
    tab = rs.randn(2, 160, 8, xqc).astype(np.float32)
    oy = rs.randint(0, 160 - wh, 3).astype(np.int32)
    jx = rs.randint(0, 8 - ns, 3).astype(np.int32)
    img = np.array([0, 1, 1], np.int32)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(3,), in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 1), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((wh, ns * xqc), jnp.bfloat16), pltpu.SemaphoreType.DMA],
    )
    ref = np.asarray(pl.pallas_call(jax_tool._dma_kernel, grid_spec=grid_spec,
                                    out_shape=jax.ShapeDtypeStruct((3, 1), jnp.float32), interpret=True)(
        jnp.asarray(oy), jnp.asarray(jx), jnp.asarray(img), jnp.asarray(tab, jnp.bfloat16)))
    ttab = torch.from_numpy(tab).bfloat16()
    got = window_sum(ttab, *(torch.from_numpy(a) for a in (oy, jx, img)), wh, ns)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1)
    # relative to the largest sum: a sum near 0 keeps the other sums' rounding
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert window_sum.launches == 0
    # a window that leaves the table has no sum
    bad = window_sum_reference(ttab, *(torch.tensor([v], dtype=torch.int32) for v in (160 - wh + 1, 0, 0)), wh, ns)
    assert torch.isnan(bad).all()


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
