"""Offline matching of a pair list: ``MatchEngine.match_paths`` over a
stream of JPEG pair files that cycles through the window, as a user
matches the pairs of a reconstruction.

Mix parameters: ``pairs`` files written in set-up from the seed, pair i at
``sizes[i % len(sizes)]`` (h, w), JPEG ``quality``; ``batch_size``;
``warmup_batches`` before the window; ``keep`` results of the first
``keep_among`` pairs kept for the check (drawn from the seed);
``trace_after`` and ``trace_batches``: the traced stretch of a ``--trace 1``
run, in batches; ``limits``: the check's limits.
"""
from __future__ import annotations

import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from perfbench.lib import matching
from perfbench.lib.profile import span
from perfbench.lib.traffic import sub_seed, synthetic_pair

POOL_STREAM, KEEP_STREAM = 3, 4
REPEATS = 1000  # the stream's length in passes over the files: more than any window takes


class State:
    pass


def _write_pair(d: Path, i: int, seed: int, hw, quality: int):
    a, b = synthetic_pair(sub_seed(seed, POOL_STREAM, i), tuple(hw))
    paths = (str(d / f"{i:03d}_A.jpg"), str(d / f"{i:03d}_B.jpg"))
    a.save(paths[0], quality=quality)
    b.save(paths[1], quality=quality)
    return paths


def setup(run):
    from roma_tpu_torch.serving import MatchEngine

    mix = run.mix
    s = State()
    s.tmp = tempfile.TemporaryDirectory(prefix="perfbench_")
    d = Path(s.tmp.name)
    sizes = mix["sizes"]
    with ThreadPoolExecutor(8) as ex:
        s.files = list(ex.map(lambda i: _write_pair(d, i, run.seed, sizes[i % len(sizes)], mix["quality"]),
                              range(mix["pairs"])))
    s.matcher = matching.build_matcher(run)
    s.engine = MatchEngine(s.matcher, batch_size=mix["batch_size"])
    s.keep_tokens = matching.KeepTokens(s.matcher)
    # half of the kept results from the first half of a batch's rows, half from the second
    rs = np.random.RandomState(sub_seed(run.seed, KEEP_STREAM))
    bs = mix["batch_size"]
    rows = [[i for i in range(mix["keep_among"]) if (i % bs < bs // 2) == first] for first in (True, False)]
    s.keep_at = sorted(rs.choice(rows[0], mix["keep"] // 2, replace=False).tolist()
                       + rs.choice(rows[1], mix["keep"] - mix["keep"] // 2, replace=False).tolist())
    s.kept = {}
    run.warm_start()
    n = mix["warmup_batches"] * mix["batch_size"]
    for _ in s.engine.match_paths([s.files[i % len(s.files)] for i in range(n)]):
        pass
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return s


def window(run, s, tracer):
    mix = run.mix
    bs = mix["batch_size"]
    keep_rows = {}  # batch -> the kept pairs' rows in it
    for i in s.keep_at:
        keep_rows.setdefault(i // bs, []).append(i % bs)
    tokens = {}
    dispatched = [0]

    def sink(name, out):  # block 0's MLP and block 0 come first, then the whole encoder, once a batch
        # the kept pairs' A and B rows alone, so what is held does not depend on how they fall in batches
        for p in keep_rows.get(dispatched[0], ()):
            tokens[(dispatched[0] * bs + p, name)] = out[[p, bs + p]]
        if name == "dinov2":
            dispatched[0] += 1

    s.keep_tokens.sink = sink
    stream = [s.files[i % len(s.files)] for i in range(REPEATS * len(s.files))]
    done, traced_done, counts = 0, 0, None
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    it = s.engine.match_paths(stream)
    traced = False
    try:
        while True:
            with span("perfbench.next_result", traced):
                r = next(it)
            done += 1
            if r.index in s.keep_at:
                s.kept[r.index] = {"warp": r.warp.clone(), "certainty": r.certainty.clone()}
            if done % bs:
                continue
            batches = done // bs
            if tracer is not None and batches == mix["trace_after"]:
                counts, traced_done, traced = _launches(), done, True
                tracer.start()
            if tracer is not None and batches == mix["trace_after"] + mix["trace_batches"]:
                tracer.stop()
                traced = False
                after = _launches()
                run.records.update(trace=tracer.reading, traced_launches={k: after[k] - counts[k] for k in after},
                                   traced_s=tracer.spent_s, traced_units=done - traced_done,
                                   traced_rounds=(done - traced_done) // bs)
            now = time.perf_counter()
            if now >= t_end and (tracer is None or "trace" in run.records):
                break
    finally:
        it.close()
    t = now - t0
    s.keep_tokens.sink = None
    for (i, name), rows in tokens.items():
        if i in s.kept:
            s.kept[i][name] = rows
    for i, k in s.kept.items():
        k["pair"] = tuple(Image.open(p).convert("RGB") for p in s.files[i % len(s.files)])
    run.records.update(attempted=done, failed=0, window_s=t, units=done)
    return {"pairs_per_s": done / t}


def _launches() -> dict:
    from roma_tpu_torch.ops import KERNEL_WRAPPERS

    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def release(run, s):
    s.keep_tokens.remove()
    del s.engine, s.matcher, s.keep_tokens


def check(run, s):
    try:
        kept = [s.kept[i] for i in s.keep_at if i in s.kept]
        return matching.check_kept(run, kept)
    finally:
        s.tmp.cleanup()
