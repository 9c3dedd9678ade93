"""The device's idle share of the traced stretch of the window, in %:
100 * (1 - the union of kernel, copy and memset intervals over all streams
/ the traced stretch's length)."""
from perfbench.lib.profile import idle_share


def read(run):
    return idle_share(run.records.get("trace"))
