"""The training step's backward on the device: CUDA events around the
program's ``roma.train.backward`` span, device clock with its idle gaps,
mean a step of the traced stretch, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.train.backward", "device_ms")
