"""The card run's own checks, on the CPU: chip_smoke.py's spill gate on a
ptxas report, the bf16 ulp its attention bar counts in, and where the build
keeps the report it reads."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from roma_tpu_torch import _ext  # noqa: E402

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
