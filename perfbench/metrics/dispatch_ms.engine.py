"""The engine's dispatch of a batch: the host wall time of the program's
``roma.engine.dispatch`` span (the pinned copy to the card and the match's
enqueue on the main thread), mean a batch of the traced stretch, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.engine.dispatch")
