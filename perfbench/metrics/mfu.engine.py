"""The whole match's share of the card's bf16 peak, in %: the plain
reference's operations for one pair (torch's FlopCounterMode, cached under
build/perfbench/) times the pairs completed a second, over 989 TFLOP/s; the
traced stretch, which the profiler slows, is left out of the pairs and the
seconds."""
from perfbench.lib import costs


def read(run):
    rate = costs.untraced_rate(run.records)
    if rate is None:
        return None
    return 100.0 * costs.model_flops(run.cfg["model"], "match", run.out_dir) * rate / costs.PEAK_BF16
