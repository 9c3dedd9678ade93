"""A cell of the benchmark cut to ``RoMaConfig.tiny()`` and small canvases,
for the CPU tests of the harness: every path of a run but the card."""
from __future__ import annotations

import copy
import dataclasses
import time

from perfbench.lib import harness, spec


def tiny_model() -> dict:
    from roma_tpu_torch import RoMaConfig

    cfg = dataclasses.asdict(RoMaConfig.tiny())
    return {k: [list(x) if isinstance(x, tuple) else x for x in v] if isinstance(v, tuple) else v
            for k, v in cfg.items() if not isinstance(v, bool)}


TINY_MIXES = {
    "single": dict(pool=3, image_hw=[90, 120], num_samples=200, warmup=1, keep=2, keep_among=3,
                   trace_after=1, trace_requests=1),
    "train": dict(pool=3, render_threads=2, checked_steps=3, trace_after=1, trace_steps=1),
    "engine": dict(pairs=6, sizes=[[90, 120], [120, 160]], batch_size=2, warmup_batches=1, keep=2, keep_among=6,
                   trace_after=1, trace_batches=1),
}


def tiny_cell(name: str, dtype: str = "float32", limits: dict | None = None):
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    model = dict(tiny_model(), vit_gelu_tanh=cell.config["model"].get("vit_gelu_tanh", False))
    for k in ("coarse_res", "upsample_res", "train_res"):
        if k in cell.config["model"]:
            model[k] = {"coarse_res": [56, 56], "upsample_res": [84, 84], "train_res": [112, 112]}[k]
    cell.config.update(model=model, dtype=dtype)
    if "batch_size" in cell.config:
        cell.config["batch_size"] = 2
    cell.mix = dict(copy.deepcopy(cell.mix), **TINY_MIXES.get(cell.mix["driver"], {}))
    if limits is not None:
        cell.mix["limits"] = limits
    return cell


def run_tiny(cell, seed=1, seconds=2.0, trace=False, **kw) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu", **kw)
