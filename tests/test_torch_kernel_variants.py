"""roma_tpu_torch.tools.kernel_variants on the CPU: every variant's text
replacements still apply to the current CUDA sources, and a run without a
card stops before building anything."""
import pytest
import torch

from roma_tpu_torch import _ext
from roma_tpu_torch.tools import kernel_variants as kv


@pytest.mark.parametrize("name", sorted(kv.VARIANTS))
def test_variant_applies_to_the_source(name):
    source, reps = kv.VARIANTS[name]
    text = kv.variant_source(source, reps)
    assert (text == (_ext._CSRC / source).read_text()) == (not reps)


def test_a_stale_replacement_raises():
    with pytest.raises(ValueError, match="not in the source"):
        kv.variant_source("local_corr.cu", [("no such text", "")])


def test_no_card_stops_the_run():
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(SystemExit):
        kv.main([])
