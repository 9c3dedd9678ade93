"""The host's bicubic resizes of a request: the host wall time of the
program's ``roma.match.resize`` spans (PIL, both images at both canvases),
summed a request, mean over the traced stretch's requests, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.match.resize")
