"""The copy of a training batch to the card: the host wall time of the
program's ``roma.loader.to_device`` span (pinning and the non-blocking
copies), mean a step of the traced stretch, in ms."""
from perfbench.lib import spans


def read(run):
    return spans.mean_per_unit("roma.loader.to_device")
