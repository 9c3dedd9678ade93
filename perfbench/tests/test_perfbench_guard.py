"""A run refuses the CPU and a process holding the JAX stack or the JAX
package; module names are compared by their top-level name, whole."""
import os
import subprocess
import sys

import pytest

from perfbench.lib import guard, spec


def test_whole_top_level_names():
    assert guard.forbidden_modules(["roma_tpu_torch", "roma_tpu_torch.ops", "roma_tpu_x", "jaxtyping",
                                    "flaxen", "numpy"]) == []
    assert guard.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "roma_tpu",
                                    "roma_tpu.models", "torch"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "roma_tpu", "roma_tpu.models"])
    with pytest.raises(guard.Refused):
        guard.require_no_jax(["torch", "roma_tpu.ops"])
    guard.require_no_jax(["torch", "roma_tpu_torch.ops"])


def test_the_cpu_is_refused(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(guard.Refused):
        guard.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(guard.Refused):
        guard.require_cards(4)


def test_run_refuses_a_machine_without_a_card():
    """The command itself: no card here, so a non-zero exit and no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "match560_single", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_the_program_imports_no_jax():
    """The program and the benchmark's own modules load without the JAX stack."""
    code = ("import sys; sys.path.insert(0, '.');"
            "import roma_tpu_torch, roma_tpu_torch.serving, roma_tpu_torch.train, roma_tpu_torch.datasets.loader;"
            "import perfbench.lib.matching, perfbench.reference.train, perfbench.lib.costs, perfbench.lib.profile;"
            "from perfbench.lib import guard; guard.require_no_jax(); print('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        text = path.read_text()
        assert "roma_tpu" not in text.replace("roma_tpu_torch's", "").replace("roma_tpu_torch computes", ""), path
