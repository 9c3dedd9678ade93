"""Single requests in a closed loop with one client: each request matches one
pair of in-memory PIL images with ``RegressionMatcher.match``, samples
correspondences and brings their pixel coordinates to the host, as an SfM
or localization pipeline calls RoMa pair by pair.

Mix parameters: ``pool`` pairs made by ``synthetic_pair`` at ``image_hw``,
drawn in turn; ``num_samples`` correspondences a request; ``warmup``
requests before the window; ``keep``: how many requests of the first
``keep_among`` have their answers kept for the check (drawn from the seed);
``trace_after`` and ``trace_requests``: the traced stretch of a ``--trace
1`` run; ``limits``: the check's limits.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench.lib import matching
from perfbench.lib.profile import span
from perfbench.lib.traffic import sub_seed, synthetic_pair

POOL_STREAM, KEEP_STREAM = 1, 2


class State:
    pass


def setup(run):
    mix = run.mix
    hw = tuple(mix["image_hw"])
    with ThreadPoolExecutor(8) as ex:
        pool = list(ex.map(lambda i: synthetic_pair(sub_seed(run.seed, POOL_STREAM, i), hw), range(mix["pool"])))
    s = State()
    s.pool = pool
    s.matcher = matching.build_matcher(run)
    s.keep_tokens = matching.KeepTokens(s.matcher)
    rs = np.random.RandomState(sub_seed(run.seed, KEEP_STREAM))
    s.keep_at = set(rs.choice(mix["keep_among"], mix["keep"], replace=False).tolist())
    s.kept = []
    run.warm_start()
    for i in range(mix["warmup"]):
        request(run, s, s.pool[i % len(s.pool)])
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return s


def request(run, s, pair, keep: dict | None = None, traced: bool = False):
    """One request: match, sample, pixel coordinates on the host; its stages
    named in the trace when ``traced``."""
    m = s.matcher
    a, b = pair
    with span("perfbench.match", traced):
        warp, cert = m.match(a, b)
    with span("perfbench.sample", traced):
        matches, _ = m.sample(warp, cert, run.mix["num_samples"])
    with span("perfbench.to_host", traced):
        k_a, k_b = m.to_pixel_coordinates(matches, a.size[1], a.size[0], b.size[1], b.size[0])
        k_a, k_b = k_a.cpu(), k_b.cpu()
    if keep is not None:
        keep.update(warp=warp, certainty=cert, kpts=(k_a, k_b), pair=pair)
    return k_a, k_b


class NetSpans:
    """Forward hooks on ``matcher.net``: the host time from the call of
    ``match`` to the first net call (host prep), and CUDA events around
    each net call, the first of a request the coarse pass, the second the
    upsample pass."""

    def __init__(self, net):
        self.t_call = None
        self.prep_s, self.events = [], []
        self.calls = 0
        self.handles = [net.register_forward_pre_hook(self._pre), net.register_forward_hook(self._post)]

    def begin(self, t_call: float):
        self.t_call, self.calls = t_call, 0

    def _pre(self, module, args):
        if self.calls == 0:
            self.prep_s.append(time.perf_counter() - self.t_call)
            self.events.append([])
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[-1].append(e)

    def _post(self, module, args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[-1].append(e)
        self.calls += 1

    def remove(self):
        for h in self.handles:
            h.remove()

    def pass_ms(self) -> tuple[list[float], list[float]]:
        torch.cuda.synchronize()
        coarse = [ev[0].elapsed_time(ev[1]) for ev in self.events if len(ev) == 4]
        up = [ev[2].elapsed_time(ev[3]) for ev in self.events if len(ev) == 4]
        return coarse, up


def window(run, s, tracer):
    mix = run.mix
    spans = NetSpans(s.matcher.net) if tracer is not None and run.device.type == "cuda" else None
    lat = []
    i = 0
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    while True:
        if tracer is not None and i == mix["trace_after"]:
            tracer.start()
        keep = {} if i in s.keep_at else None
        if keep is not None:
            s.keep_tokens.sink = lambda name, out, keep=keep: keep.setdefault(name, out)
        t = time.perf_counter()
        if spans is not None:
            spans.begin(t)
        request(run, s, s.pool[i % len(s.pool)], keep, traced=tracer is not None)
        now = time.perf_counter()
        lat.append(now - t)
        s.keep_tokens.sink = None
        if keep is not None:
            s.kept.append(keep)
        i += 1
        if tracer is not None and i == mix["trace_after"] + mix["trace_requests"]:
            tracer.stop()
            run.records["trace"] = tracer.reading
        if now >= t_end and (tracer is None or tracer.reading is not None):
            break
    run.records.update(attempted=i, failed=0, window_s=now - t0, latencies_s=lat)
    if spans is not None:
        coarse, up = spans.pass_ms()
        run.records.update(host_prep_s=spans.prep_s, coarse_ms=coarse, upsample_ms=up)
        spans.remove()
    return {"latency_p95_ms": 1e3 * float(np.percentile(lat, 95))}


def release(run, s):
    s.keep_tokens.remove()
    del s.matcher, s.keep_tokens


def check(run, s):
    return matching.check_kept(run, s.kept)
