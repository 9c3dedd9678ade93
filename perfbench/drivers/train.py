"""Back-to-back steps of the recipe's training step (train_roma_outdoor's
``build()``: RoMaNet with remat, RobustLosses, two-group AdamW after a
global-norm clip, bf16 autocast), each on a batch copied to the card by the
port's ``datasets.to_device`` and ending with its loss read back.

Mix parameters: ``pool`` batches of the configuration's ``batch_size``
posed pairs (analytic textured planes, exact depth and pose) rendered in
set-up from the seed on ``render_threads`` host threads and used in turn;
the first ``checked_steps`` steps are set-up and are what the check
compares with the plain reference; ``trace_after`` and ``trace_steps``: the
traced stretch of a ``--trace 1`` run, in window steps; ``limits``.

The numbers, each against the plain float32 reference that takes the same
first steps from the same weights and batches (the mix's ``limits`` name
those compared; the rest are kept as readings):

* ``dino_mlp0_rel_rms``: the rms difference of the first step's output of
  DINOv2's first MLP (run by the step's forward) over the reference's rms;
  a batch that does not match the reference's reads infinite;
* ``grad_gap_median``: the median leaf's gap between the norms of the first
  step's clipped gradient as the optimizer got it (its first moment after
  one step over 1 - beta1) and the reference's, over the larger of that
  leaf's reference norm and the median leaf's; ``grad_gap_p90``: the 90th
  percentile leaf's; ``grad_gap``: the worst leaf's;
* ``change_gap_median``, ``change_gap_p90``, ``change_gap``: the same for
  each leaf's change over the checked steps;
* ``loss_gap``: the largest relative gap of a step's loss.

Leaves whose reference gradient is under a thousandth of the median leaf's
(biases right before a BatchNorm, whose gradient is nought to rounding) are
left out of the gradient and change numbers: Adam moves them by round-off.
The readings also name the worst leaves, with each one's reference gradient
over the median leaf's and, for leaves of at most ``SMALL_LEAF`` entries,
the norm of the difference of the two first-step gradients over the
reference's (``grad_diff``).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench.lib.harness import Compared
from perfbench.lib.matching import peaked_bias, port_config, weights
from perfbench.lib.profile import span
from perfbench.lib.traffic import posed_batch, sub_seed
from perfbench.reference import roma as R
from perfbench.reference import train as RT

POOL_STREAM = 5
FAULTS = ("half_batch", "unchanged")
SMALL_LEAF = 1 << 16  # leaves whose first-step gradient is kept whole for the readings


class State:
    pass


def _half_rows(objective):
    """The objective over the first half of the batch's rows alone: the
    forward still runs the whole batch, the mean is taken over the rest."""

    def cut(x, b):
        if isinstance(x, dict):
            return {k: cut(v, b) for k, v in x.items()}
        return x[: b // 2] if torch.is_tensor(x) and x.ndim and x.shape[0] == b else x

    def halved(corresps, batch):
        b = batch["im_A"].shape[0]
        return objective(cut(corresps, b), cut(batch, b))

    return halved


def _trainable(name: str) -> bool:
    return not name.startswith("encoder.dinov2.") and not name.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))


def _lr_of(cfg):
    o = cfg["optimizer"]
    return lambda name: o["encoder_lr"] if name.split(".")[0] == "encoder" else o["decoder_lr"]


def _leaf_norms(ts: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in ts.items()}


def setup(run):
    from roma_tpu_torch.datasets.loader import to_device
    from roma_tpu_torch.models.zoo import build_net
    from roma_tpu_torch.train import RobustLosses, make_optimizer, make_train_step

    cfg, mix = run.cfg, run.mix
    res = cfg["model"]["train_res"][0]
    rs = np.random.RandomState(sub_seed(run.seed, POOL_STREAM))
    with ThreadPoolExecutor(mix["render_threads"]) as ex:
        pool = [posed_batch(rs, cfg["batch_size"], res, ex) for _ in range(mix["pool"])]
    s = State()
    s.pool, s.to_device = pool, to_device
    s.net = build_net(port_config(cfg, False), run.device, remat=cfg["remat"])
    with torch.no_grad():
        s.net.load_state_dict(weights(run))
    s.net.train()
    o = cfg["optimizer"]
    s.opt = make_optimizer(s.net, o["encoder_lr"], o["decoder_lr"], tuple(o["milestones"]),
                           weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
    loss = cfg["loss"]
    objective = RobustLosses(ce_weight=loss["ce_weight"], local_dist=tuple(tuple(x) for x in loss["local_dist"]),
                             local_largest_scale=loss["local_largest_scale"], alpha=loss["alpha"], c=loss["c"])
    if run.fault == "half_batch":  # half of the batch left out, the mean taken over the rest
        objective = _half_rows(objective)
    amp = {"bfloat16": torch.bfloat16, "float32": None}[cfg["dtype"]]
    bias = _bias(run)
    s.step = make_train_step(s.net, objective, s.opt, amp_dtype=amp,
                             forward=lambda net, b: net(b["im_A"], b["im_B"], gm_logit_bias=bias))
    if run.fault == "unchanged":  # a step that leaves the state as it was
        s.opt.step = lambda: None
    run.warm_start()
    # the first steps, through the window's own call and feed, are what the check compares
    s.losses = []
    for i in range(mix["checked_steps"]):
        if i == 0:  # the first step's DINOv2 reading, in set-up only
            got = {}
            hook = s.net.encoder.dinov2.blocks[0].mlp.register_forward_hook(
                lambda m, a, out: got.setdefault("dinov2_mlp0", out.detach()))
        s.losses.append(float(s.step(to_device(s.pool[i % len(pool)], run.device))["loss"]))
        if i == 0:
            hook.remove()
            s.mlp0 = got["dinov2_mlp0"].to("cpu")
            s.grad_norms, s.small_grads = _first_grads(s)
    s.params_after = {k: p.detach().to("cpu", copy=True) for k, p in s.net.named_parameters() if p.requires_grad}
    if run.control:
        _control_readings(run, s)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return s


def _bias(run):
    """The peaked anchor-logit field both sides add to the coarse logits
    (``matching.peaked_bias``), at the training canvas."""
    m = run.cfg["model"]
    return peaked_bias(m, run.device, hw=m["train_res"])


def _first_grads(s) -> tuple[dict, dict]:
    """Each trainable leaf's norm of the gradient the optimizer got in the
    first step: its first moment after one step over 1 - beta1 (0 where it
    holds none); and that gradient whole, on the host, for the leaves of at
    most SMALL_LEAF entries."""
    norms, small = {}, {}
    beta1 = s.opt.param_groups[0]["betas"][0]
    for k, p in s.net.named_parameters():
        if p.requires_grad:
            st = s.opt.adamw.state.get(p, {})
            g = st["exp_avg"] / (1 - beta1) if "exp_avg" in st else torch.zeros_like(p)
            norms[k] = float(torch.linalg.vector_norm(g))
            if p.numel() <= SMALL_LEAF:
                small[k] = g.float().cpu()
    return norms, small


def _control_readings(run, s):
    """The control in the program's place: the plain reference with float8
    operands takes the checked steps; its readings replace the program's."""
    w = weights(run)
    grads, small = {}, {}

    def on_step(i, loss, seen):
        if i == 0:
            grads.update(_leaf_norms(seen))
            small.update({k: seen[k].float().cpu() for k in s.small_grads if k in seen})

    batches = [_tensors(b, run.device) for b in s.pool[: run.mix["checked_steps"]]]
    keep = {}
    s.losses = RT.train_steps(run.cfg, w, batches, _trainable, _lr_of(run.cfg), _loss_kw(run.cfg), on_step,
                              fp8=True, keep_first=keep, gm_logit_bias=_bias(run))
    s.grad_norms, s.small_grads = grads, small
    s.mlp0 = keep["dinov2_mlp0"].to("cpu")
    s.params_after = {k: w[k].detach().to("cpu", copy=True) for k in s.params_after}
    del w


def _tensors(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _loss_kw(cfg):
    loss = cfg["loss"]
    return dict(ce_weight=loss["ce_weight"], local_dist={int(s): d for s, d in loss["local_dist"]},
                local_largest_scale=loss["local_largest_scale"], alpha=loss["alpha"], c=loss["c"])


def window(run, s, tracer):
    from roma_tpu_torch.ops import KERNEL_WRAPPERS

    mix, n = run.mix, len(s.pool)
    counts = lambda: {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    steps, before, traced = 0, None, False
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    while True:
        if tracer is not None and steps == mix["trace_after"]:
            before, traced = counts(), True
            tracer.start()
        with span("perfbench.to_device", traced):
            batch = s.to_device(s.pool[(mix["checked_steps"] + steps) % n], run.device)
        with span("perfbench.step", traced):
            metrics = s.step(batch)
        with span("perfbench.loss_to_host", traced):
            float(metrics["loss"])
        steps += 1
        if tracer is not None and steps == mix["trace_after"] + mix["trace_steps"]:
            tracer.stop()
            traced = False
            after = counts()
            run.records.update(trace=tracer.reading, traced_launches={k: after[k] - before[k] for k in after},
                               traced_s=tracer.spent_s, traced_units=mix["trace_steps"] * run.cfg["batch_size"],
                               traced_rounds=mix["trace_steps"])
        now = time.perf_counter()
        if now >= t_end and (tracer is None or "trace" in run.records):
            break
    t = now - t0
    samples = steps * run.cfg["batch_size"]
    run.records.update(attempted=steps, failed=0, window_s=t, units=samples)
    return {"samples_per_s": samples / t}


def release(run, s):
    del s.step, s.opt, s.net


def check(run, s) -> list[Compared]:
    R.strict_float32()
    cfg, k = run.cfg, run.mix["checked_steps"]
    w = weights(run)
    ref_grads, ref_small = {}, {}

    def on_step(i, loss, seen):
        if i == 0:
            ref_grads.update(_leaf_norms(seen))
            ref_small.update({n: seen[n].float().cpu() for n in s.small_grads if n in seen})

    batches = [_tensors(b, run.device) for b in s.pool[:k]]
    keep = {}
    ref_losses = RT.train_steps(cfg, w, batches, _trainable, _lr_of(cfg), _loss_kw(cfg), on_step, keep_first=keep,
                                gm_logit_bias=_bias(run))
    ref_mlp0 = keep.pop("dinov2_mlp0").float()
    got_mlp0 = s.mlp0.to(run.device).float()
    mlp0 = (float((got_mlp0 - ref_mlp0).pow(2).mean().sqrt() / ref_mlp0.pow(2).mean().sqrt())
            if got_mlp0.shape == ref_mlp0.shape else float("inf"))
    del batches, keep, ref_mlp0, got_mlp0
    w0 = weights(run)
    ref_change = {n: float(torch.linalg.vector_norm(w[n] - w0[n])) for n in s.params_after}
    got_change = {n: float(torch.linalg.vector_norm(s.params_after[n].to(run.device) - w0[n]))
                  for n in s.params_after}
    del w, w0
    med_g = float(np.median([v for v in ref_grads.values()]))
    live = [n for n in s.params_after if ref_grads.get(n, 0.0) >= 1e-3 * med_g]
    med_c = float(np.median([ref_change[n] for n in live]))

    def gaps(got, ref, med):  # each live leaf's gap of norms, largest first
        return sorted(((abs(got.get(n, 0.0) - ref[n]) / max(ref[n], med), n) for n in live), reverse=True)

    def diff(n):  # the first-step gradients' difference over the reference's, a small leaf's
        if n not in ref_small or n not in s.small_grads:
            return None
        r = torch.linalg.vector_norm(ref_small[n])
        return float(torch.linalg.vector_norm(s.small_grads[n] - ref_small[n]) / r) if r > 0 else None

    def named(gs, got, ref):
        return [[n, v, got.get(n, 0.0), ref[n], ref_grads.get(n, 0.0) / med_g, diff(n)] for v, n in gs[:6]]

    g, c = gaps(s.grad_norms, ref_grads, med_g), gaps(got_change, ref_change, med_c)
    q = lambda gs, p: float(np.percentile([v for v, _ in gs], p))
    nums = {"dino_mlp0_rel_rms": mlp0,
            "grad_gap_median": q(g, 50), "grad_gap_p90": q(g, 90), "grad_gap": g[0][0],
            "change_gap_median": q(c, 50), "change_gap_p90": q(c, 90), "change_gap": c[0][0],
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(s.losses, ref_losses))}
    small = sorted(((d, n) for n in live if (d := diff(n)) is not None), reverse=True)
    run.records["check_detail"] = {
        **nums, "losses": s.losses, "ref_losses": ref_losses, "leaves": len(live),
        "left_out": len(s.params_after) - len(live), "median_grad": med_g, "median_change": med_c,
        "left_out_max_ratio": max((ref_grads.get(n, 0.0) / med_g for n in s.params_after if n not in live),
                                  default=None),
        # [leaf, gap, program norm, reference norm, reference gradient / median leaf's, grad_diff]
        "worst_grads": named(g, s.grad_norms, ref_grads), "worst_changes": named(c, got_change, ref_change),
        "grad_diff_worst": [[n, d] for d, n in small[:6]],
        "live_lowest_ratios": sorted([ref_grads[n] / med_g, n] for n in live)[:4],
        "grad_diff_median": float(np.median([d for d, _ in small])) if small else None}
    limits = run.mix["limits"]
    return [Compared(n, nums[n], float(limits[n])) for n in limits]
