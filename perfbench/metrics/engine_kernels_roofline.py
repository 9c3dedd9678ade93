"""Kernels A-D in the engine's traced batches, in %: the sum of each launch's
least time (bytes or operations over the card's peak, from the shapes a
batch launches) over the sum of those kernels' device times in the trace.
The program's launch counters over the traced stretch have to be exactly
the launches a batch makes times the traced batches, and the trace has to
show every kernel; else the share is not read."""
from perfbench.lib import costs


def read(run):
    m = run.cfg["model"]
    per_batch = costs.match_launches(m, run.mix["batch_size"], m["coarse_res"], m["upsample_res"])
    return costs.kernels_roofline(run.records, per_batch)
