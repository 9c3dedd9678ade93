"""The refiners' device time: the program's ``roma.net.refine.s<scale>``
spans (each ConvRefiner call with its Kernel B, C and D launches, every
scale of both passes; CUDA events on the current stream, gaps included),
summed a batch and averaged over the traced stretch's batches, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.net.refine.", "device_ms")
