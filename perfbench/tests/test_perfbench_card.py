"""On the card, at each cell's own sizes and limits: a sound run is
correct, and the lower-precision control and the planted faults are not.
Skipped without a CUDA device; run on the card with

    python3 -m pytest perfbench/tests -m card
"""
import pytest
import torch

from perfbench.calibrate import calibrate

CASES = [("match560_single", ["shifted_warp", "scaled_cert"]), ("match560_engine_b8", ["shifted_warp", "scaled_cert"]),
         ("train560_b8_remat", ["half_batch", "unchanged"])]


@pytest.mark.card
@pytest.mark.parametrize("name, faults", CASES, ids=[c[0] for c in CASES])
def test_the_cell_separates_sound_runs_from_the_control_and_faults(name, faults):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows = calibrate(name, [3_000_000_001], [3_000_000_002], faults, 6.0)
    assert rows[0]["correct"], rows[0]["checks"]
    assert not any(r["correct"] for r in rows[1:]), [(r["kind"], r["checks"]) for r in rows[1:]]
