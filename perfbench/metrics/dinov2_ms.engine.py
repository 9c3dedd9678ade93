"""DINOv2's device time: the program's ``roma.net.dinov2`` spans (CUDA
events on the current stream, gaps included; the coarse pass alone), summed
a batch and averaged over the traced stretch's batches, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.net.dinov2", "device_ms")
