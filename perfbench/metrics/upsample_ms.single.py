"""The upsample pass: CUDA events around the second ``matcher.net`` call
of a request (VGG and refiners 8 -> 1 at the upsample canvas), device
clock with its idle gaps, averaged over the window's requests, in ms."""


def read(run):
    v = run.records.get("upsample_ms")
    return sum(v) / len(v) if v else None
