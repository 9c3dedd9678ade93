"""The global match's device time: the program's ``roma.net.gm`` spans (GP,
TransformerDecoder, the logit bias and ``cls_to_flow_refine``; CUDA events
on the current stream, gaps included), summed a batch and averaged over the
traced stretch's batches, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.net.gm", "device_ms")
