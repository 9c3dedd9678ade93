"""Kernels A and E in the traced training steps, in %: the sum of each
launch's least time (bytes or operations over the card's peak, from the
shapes a step launches) over the sum of those kernels' device times in the
trace. The program's launch counters over the traced stretch have to be
exactly the launches a step makes times the traced steps, and the trace
has to show every kernel; else the share is not read."""
from perfbench.lib import costs


def read(run):
    c = run.cfg
    per_step = costs.train_launches(c["model"], c["batch_size"], c["model"]["train_res"], c["remat"])
    return costs.kernels_roofline(run.records, per_step)
