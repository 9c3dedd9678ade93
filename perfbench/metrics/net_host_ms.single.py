"""The host's dispatch of a request's two passes: the host wall time of the
program's ``roma.match.coarse`` and ``roma.match.upsample`` spans, summed a
request, mean over the traced stretch's requests, in ms; beside their
device time in ``coarse_ms`` and ``upsample_ms``."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit(("roma.match.coarse", "roma.match.upsample"))
