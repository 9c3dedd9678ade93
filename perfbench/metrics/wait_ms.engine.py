"""The engine's consumer blocked on the prepared batches: the host wall
time of the program's ``roma.engine.wait`` span (the main thread waiting for
the producer thread's next batch), mean a batch of the traced stretch, in
ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.engine.wait")
