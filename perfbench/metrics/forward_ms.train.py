"""The training step's forward and objective on the device: CUDA events
around the program's ``roma.train.forward`` span, device clock with its idle
gaps, mean a step of the traced stretch, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.train.forward", "device_ms")
