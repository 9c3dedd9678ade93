"""The coarse pass: CUDA events around the first ``matcher.net`` call of a
request (VGG, DINOv2, GP, decoder, refiners 16 -> 1 at the coarse canvas),
device clock with its idle gaps, averaged over the window's requests, in ms."""


def read(run):
    v = run.records.get("coarse_ms")
    return sum(v) / len(v) if v else None
