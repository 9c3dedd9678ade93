"""The training step's update on the device: CUDA events around the
program's ``roma.train.optimizer`` span (gradient statistics, the clip,
AdamW), device clock with its idle gaps, mean a step of the traced stretch,
in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.train.optimizer", "device_ms")
