"""The VGG19-BN pyramid's device time: the program's ``roma.net.vgg`` spans
(CUDA events on the current stream, gaps included; both passes), summed a
batch and averaged over the traced stretch's batches, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.net.vgg", "device_ms")
