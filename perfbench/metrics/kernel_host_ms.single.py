"""The host time inside the kernel wrappers of a request: the host wall time
of the program's ``roma.ops.*`` spans (one a wrapper call, the outermost
where one wrapper calls another), summed a request, mean over the traced
stretch's requests, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.ops.", outermost=True)
