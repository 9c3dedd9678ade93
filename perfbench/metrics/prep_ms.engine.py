"""The engine's host preparation of a batch: the host wall time of the
program's ``roma.engine.prep`` span (decode and bicubic resize of a batch's
images on the engine's producer thread and its pool), mean a batch of the
traced stretch, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.engine.prep")
