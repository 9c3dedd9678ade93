"""The port against the JAX package at full dims, on the CPU: per-scale parity
of the two-pass match and the cross-implementation pose-AUC capstone.

    python -m tests.torch_crossimpl            # 560 -> 864: parity, then the capstone at gains 0.02 and 1.0
    python -m tests.torch_crossimpl --golden   # 672 -> 1344: the capstone at gain 0.02, float32

Both sides hold the weights of ``roma_tpu_torch.tools.crossimpl.capstone_net``
(drawn on the CPU, carried to JAX through ``models/zoo/convert.to_reference``
and ``roma_tpu.models.zoo.convert.convert_roma``) and receive the same
logit-aware bias, solved against the port's own float32 scale-16
``cls_logits`` of each synthetic scene.

Parity (scene 0, refiner_flow_gain 1.0, symmetric): the port's float32
``RoMaNet`` against JAX float32, flow and certainty at every scale of both
passes, held to ``PARITY_ATOL`` (tests/test_roma_parity.py:427-437); this
covers the bicubic pos-embed at the 40^2 and 62^2 grids and the GP Cholesky
at 1225^2. Then the port's amp path (bf16, as ``roma_outdoor(amp=True)``)
against JAX's, both upsample passes seeded with the port's float32 coarse
flow, by the delta distribution and the anchor flip rate (as
tools/fullres_parity.py part 2).

Capstone (3 scenes x 5 repeats x 5000 samples, native RANSAC), at each gain:
(a) the gate: the port's and JAX's float32 warps through the port's
downstream (``benchmarks.pose_bench.run_pose_benchmark`` with
``PrecomputedMatcher``), the same keys; (b) each implementation's own full
pipeline (JAX's ``run_pose_benchmark`` with its keys on JAX's warps). Both
are held to ``BAR_PP`` on AUC@5/10/20; when sampling alone moves (b) past it,
(b) is rerun with more repeats on both sides and the repeats are recorded.
JAX's bf16 warps go through the port's downstream too: their AUC delta to
JAX float32, plus ``BAR_PP``, is the bar recorded for the port's amp path on
the card (chip_smoke.py's eval phase).

The port's passes and biases are computed anew on every run. JAX's passes
(minutes each on a CPU) are cached under ``CACHE`` (build/ of the checkout),
each under a digest of what it was computed from: the JAX package's sources,
the weights it was handed and its input arrays, so a change to either
package, to the weights or to the bias misses the cache. Run it detached.
Writes CROSSIMPL_AUC_TORCH.json
at the repository root with the git SHA and date. tests/test_torch_crossimpl.py
runs the same functions under ``--runslow``.
"""
from __future__ import annotations

import argparse
import datetime
import functools
import glob
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)

from roma_tpu_torch.benchmarks.pose_bench import native_estimator, run_pose_benchmark  # noqa: E402
from roma_tpu_torch.models.zoo import convert  # noqa: E402
from roma_tpu_torch.tools import crossimpl as xi  # noqa: E402

OUT = os.path.join(ROOT, "CROSSIMPL_AUC_TORCH.json")
CACHE = os.path.join(ROOT, "build", "torch_crossimpl")
GAINS = (0.02, 1.0)
PARITY_GAIN = 1.0
PARITY_ATOL = 2e-3
BAR_PP = 0.5
AUC_KEYS = ("auc_5", "auc_10", "auc_20")


def say(*a):
    print(time.strftime("%H:%M:%S"), *a, flush=True)


def jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def digest(*parts) -> str:
    """sha256 (hex, 20 digits) of strings, bytes and arrays, in order."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype}{p.shape}".encode())
            p = np.ascontiguousarray(p).tobytes()
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return h.hexdigest()[:20]


@functools.lru_cache(maxsize=None)
def jax_sources() -> str:
    """The digest of the JAX package's sources."""
    files = sorted(glob.glob(os.path.join(ROOT, "roma_tpu", "**", "*.py"), recursive=True))
    return digest(*(x for f in files for x in (os.path.relpath(f, ROOT), open(f, "rb").read())))


def jax_config(amp: bool):
    from roma_tpu.models.config import RoMaConfig

    return RoMaConfig(vit_gelu_tanh=amp)


class Weights:
    """``capstone_net(0, gain)`` in float32 on the CPU, and the same weights
    as JAX receives them (through ``models/zoo/convert.to_reference`` and
    ``roma_tpu.models.zoo.convert.convert_roma``), with their digest."""

    def __init__(self, gain):
        self.gain, self.net = gain, xi.capstone_net(0, gain, "cpu")
        self.reference = tuple(convert.state_dict_to_numpy(sd) for sd in convert.to_reference(self.net))
        self.digest = digest(*(x for sd in self.reference for k in sorted(sd) for x in (k, sd[k])))

    def variables(self):
        from roma_tpu.models.zoo import convert as jax_convert

        return jax_convert.convert_roma(*self.reference)


_WEIGHTS: dict = {}


def weights(gain) -> Weights:
    """One full-width net at a time."""
    if gain not in _WEIGHTS:
        _WEIGHTS.clear()
        _WEIGHTS[gain] = Weights(gain)
    return _WEIGHTS[gain]


def jax_cached(kind, w: Weights, inputs, make, cache=CACHE):
    """``make()``'s dict of arrays (a JAX pass), stored once under the
    digest of the JAX sources, ``w``'s weights and ``inputs``."""
    path = os.path.join(cache, f"{kind}_{digest(jax_sources(), w.digest, kind, *inputs)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    out = make()
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


_BIASES: dict = {}


def scene_bias(coarse, up, i):
    """Scene ``i``'s bias, solved against the port's float32 cls_logits
    (computed before the refiners, so the net of any gain serves), once a
    run."""
    if (coarse, up, i) not in _BIASES:
        w = next(iter(_WEIGHTS.values()), None) or weights(GAINS[0])
        _BIASES[(coarse, up, i)] = xi.scene_bias(w.net, i, coarse, up)
    return _BIASES[(coarse, up, i)]


def flow_stats(a, b, res, cell_px):
    """|a - b| in pixels at ``res``; the flip rate counts points moved by
    more than one coarse anchor cell (``cell_px``)."""
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)) * res / 2
    return {"max_px": float(d.max()), "p99_px": float(np.percentile(d, 99)), "p50_px": float(np.percentile(d, 50)),
            "anchor_flip_rate": float((d.max(-1) > cell_px).mean())}


# --------------------------------------------------------------------------
# part 1: per-scale parity
# --------------------------------------------------------------------------


def _port_passes(net, im, bias, seed=None):
    """The port's two passes on the scene's images -> ({scale: flow}, ...)
    as float32 NumPy, coarse and upsample; the upsample pass is seeded with
    ``seed`` (flow, certainty) when given, else with its own coarse pass."""
    dt = next(net.encoder.cnn.parameters()).dtype
    t = lambda a: torch.from_numpy(a).to(dt)
    (a, b, au, bu), coarse, up = im, im[0].shape[1], im[2].shape[1]
    with torch.inference_mode():
        tc = net(t(a), t(b), symmetric=True, scale_factor=math.sqrt(coarse * coarse / 560.0**2),
                 gm_logit_bias=torch.from_numpy(bias))
        flow, cert = (tc[1]["flow"], tc[1]["certainty"]) if seed is None else map(torch.from_numpy, seed)
        tu = net(t(au), t(bu), symmetric=True, upsample=True, flow=flow.float(), certainty=cert.float(),
                 scale_factor=math.sqrt(up * up / 560.0**2))
    npy = lambda res: {s: {k: v.float().numpy() for k, v in d.items()} for s, d in res.items()}
    return npy(tc), npy(tu)


def _jax_passes(variables, amp, im, bias, seed):
    jax = jax_cpu()
    import jax.numpy as jnp

    from roma_tpu.models.matcher import RoMaNet

    dt = jnp.bfloat16 if amp else jnp.float32
    net = RoMaNet(config=jax_config(amp), dtype=dt, coarse_dtype=dt)
    (a, b, au, bu), coarse, up = im, im[0].shape[1], im[2].shape[1]
    tc = jax.jit(lambda v, x, y, g: net.apply(v, x, y, symmetric=True, scale_factor=math.sqrt(coarse * coarse / 560.0**2),
                                              gm_logit_bias=g))(variables, jnp.asarray(a, dt), jnp.asarray(b, dt),
                                                                jnp.asarray(bias))
    tu = jax.jit(lambda v, x, y, f, c: net.apply(v, x, y, symmetric=True, upsample=True, flow=f, certainty=c,
                                                 scale_factor=math.sqrt(up * up / 560.0**2)))(
        variables, jnp.asarray(au, dt), jnp.asarray(bu, dt), jnp.asarray(seed[0]), jnp.asarray(seed[1]))
    npy = lambda res: {int(s): {k: np.asarray(v, np.float32) for k, v in d.items()} for s, d in res.items()}
    return npy(tc), npy(tu)


def _flat(passes):
    (c, u) = passes
    out = {f"c{s}_{k}": v for s, d in c.items() for k, v in d.items()}
    out.update({f"u{s}_{k}": v for s, d in u.items() for k, v in d.items()})
    return out


def _unflat(z):
    c, u = {}, {}
    for k, v in z.items():
        s, name = k[1:].split("_", 1)
        (c if k[0] == "c" else u).setdefault(int(s), {})[name] = v
    return c, u


def per_scale_parity(coarse, up, cache=CACHE, gain=PARITY_GAIN, scene=0):
    im = xi.scene_images(scene, coarse, up)
    w = weights(gain)
    bias = scene_bias(coarse, up, scene)
    t0 = time.time()
    port32 = _port_passes(w.net, im, bias)
    say(f"parity: port f32 passes ({time.time() - t0:.0f} s)")
    seed = (port32[0][1]["flow"], port32[0][1]["certainty"])
    inputs = (coarse, up, *im, bias, *seed)
    jax = {}
    for label, amp in (("f32", False), ("bf16", True)):
        t0 = time.time()
        jax[label] = _unflat(jax_cached(f"parity_jax_{label}", w, inputs, lambda amp=amp: _flat(
            _jax_passes(w.variables(), amp, im, bias, seed)), cache))
        say(f"parity: jax {label} passes ({time.time() - t0:.0f} s)")
    jax32, jax16 = jax["f32"], jax["bf16"]
    t0 = time.time()
    port16 = _port_passes(xi.capstone_net(0, gain, "cpu", amp=True), im, bias, seed=seed)
    say(f"parity: port bf16 passes ({time.time() - t0:.0f} s)")

    f32, bf16, jax_drift, port_drift = {}, {}, {}, {}
    for name, i, res in (("coarse", 0, coarse), ("up", 1, up)):
        for s in sorted(port32[i], reverse=True):
            key = f"{name}_s{s}"
            f32[key] = {"max_dflow": float(np.abs(port32[i][s]["flow"] - jax32[i][s]["flow"]).max()),
                        "max_dcert": float(np.abs(port32[i][s]["certainty"] - jax32[i][s]["certainty"]).max())}
            cell = coarse / 64
            bf16[key] = flow_stats(port16[i][s]["flow"], jax16[i][s]["flow"], res, cell)
            jax_drift[key] = flow_stats(jax16[i][s]["flow"], jax32[i][s]["flow"], res, cell)
            port_drift[key] = flow_stats(port16[i][s]["flow"], port32[i][s]["flow"], res, cell)
    worst = max(max(v.values()) for v in f32.values())
    return {
        "scene": scene, "refiner_flow_gain": gain,
        "f32_port_vs_jax": f32, "f32_max_abs": worst, "f32_atol": PARITY_ATOL, "f32_within": worst <= PARITY_ATOL,
        "bf16_port_vs_jax": bf16, "bf16_jax_vs_jax_f32": jax_drift, "bf16_port_vs_port_f32": port_drift,
    }


# --------------------------------------------------------------------------
# part 2: the capstone
# --------------------------------------------------------------------------


class _JaxMatchers:
    """One JAX RegressionMatcher a dtype, kept across scenes and gains (its
    programs take the variables as an argument, so they compile once)."""

    def __init__(self, coarse, up):
        self.coarse, self.up, self.m = coarse, up, {}

    def match(self, variables, amp, i, bias):
        jax_cpu()
        import jax.numpy as jnp

        from roma_tpu.models.roma import RegressionMatcher

        if amp not in self.m:
            self.m[amp] = RegressionMatcher(variables, h=self.coarse, w=self.coarse, upsample_res=(self.up, self.up),
                                            dtype=jnp.bfloat16 if amp else jnp.float32, config=jax_config(amp))
        m = self.m[amp]
        m.variables = variables
        a, b, au, bu = xi.scene_images(i, self.coarse, self.up)
        warp, cert = m.match(a[0], b[0], im_A_high_res=au[0], im_B_high_res=bu[0], gm_logit_bias=jnp.asarray(bias))
        return {"warp": np.asarray(warp, np.float32), "cert": np.asarray(cert, np.float32)}


def port_scores(results, pairs, repeats, sample_n):
    res = {k: (torch.tensor(v["warp"]), torch.tensor(v["cert"])) for k, v in results.items()}
    return run_pose_benchmark(xi.PrecomputedMatcher(res), pairs, estimator=native_estimator, repeats=repeats,
                              sample_n=sample_n, seed=0, progress=False, return_errors=True)


def jax_scores(results, pairs, repeats, sample_n):
    """JAX's own downstream: its run_pose_benchmark and the JAX tool's
    PrecomputedMatcher, with its keys."""
    jax_cpu()
    from crossimpl_auc import PrecomputedMatcher

    from roma_tpu.benchmarks.pose_bench import PosePair, native_estimator as jax_native, run_pose_benchmark as jax_run

    jpairs = [PosePair(**vars(p)) for p in pairs]
    res = {k: (v["warp"], v["cert"]) for k, v in results.items()}
    return jax_run(PrecomputedMatcher(res), jpairs, estimator=jax_native, repeats=repeats, sample_n=sample_n,
                   seed=0, progress=False, return_errors=True)


def delta_pp(s1, s2):
    d = {k: 100 * abs(s1[k] - s2[k]) for k in AUC_KEYS}
    return d, max(d.values())


def capstone(coarse, up, cache=CACHE, gains=GAINS, jax_bf16=True):
    n_scenes, repeats, sample_n = xi.N_SCENES, xi.REPEATS, xi.SAMPLE_N
    pairs = xi.scene_pairs(n_scenes, up)
    jm = _JaxMatchers(coarse, up)
    out = {}
    for gain in gains:
        w = weights(gain)
        runs = {"port_f32": {}, "jax_f32": {}} | ({"jax_bf16": {}} if jax_bf16 else {})
        variables = None
        for i in range(n_scenes):
            bias = scene_bias(coarse, up, i)
            tag = f"{coarse}to{up}_g{gain:g}_scene{i}"
            t0 = time.time()
            warp, cert = xi.match_scene(xi.matcher(w.net, coarse, up), i, bias)
            runs["port_f32"][xi.scene_tag(i)] = {"warp": warp.numpy(), "cert": cert.numpy()}
            say(f"capstone {tag} port_f32: {time.time() - t0:.0f} s")
            for run in runs:
                if run == "port_f32":
                    continue

                def make(run=run):
                    nonlocal variables
                    t0 = time.time()
                    if variables is None:
                        variables = w.variables()
                    r = jm.match(variables, run == "jax_bf16", i, bias)
                    say(f"capstone {tag} {run}: {time.time() - t0:.0f} s")
                    return r

                inputs = (coarse, up, i, *xi.scene_images(i, coarse, up), bias)
                runs[run][xi.scene_tag(i)] = jax_cached(f"match_{run}", w, inputs, make, cache)
        rec = {"match_err_px": {}, "auc": {}, "pose_errors_deg": {}}
        for run, results in runs.items():
            errs = [xi.match_error_px(results[xi.scene_tag(i)]["warp"], i, up) for i in range(n_scenes)]
            rec["match_err_px"][run] = xi.error_percentiles(errs)
            rec["auc"][run], rec["pose_errors_deg"][run] = port_scores(results, pairs, repeats, sample_n)
        rec["a_delta_pp"], rec["a_max_delta_pp"] = delta_pp(rec["auc"]["port_f32"], rec["auc"]["jax_f32"])
        rec["a_within"] = rec["a_max_delta_pp"] <= BAR_PP
        # (b): each implementation's own pipeline, more repeats only if sampling moves it
        for reps in (repeats, 4 * repeats):
            s_jax, e_jax = jax_scores(runs["jax_f32"], pairs, reps, sample_n)
            s_port, e_port = (rec["auc"]["port_f32"], rec["pose_errors_deg"]["port_f32"]) if reps == repeats else \
                port_scores(runs["port_f32"], pairs, reps, sample_n)
            d, worst = delta_pp(s_port, s_jax)
            rec["b"] = {"repeats": reps, "auc_port_pipeline": s_port, "auc_jax_pipeline": s_jax, "delta_pp": d,
                        "max_delta_pp": worst, "within": worst <= BAR_PP,
                        "pose_errors_deg_jax_pipeline": e_jax, "pose_errors_deg_port_pipeline": e_port}
            if worst <= BAR_PP:
                break
        if jax_bf16:
            _, drift = delta_pp(rec["auc"]["jax_bf16"], rec["auc"]["jax_f32"])
            rec["jax_bf16_vs_f32_max_delta_pp"] = drift
            rec["amp_bar_pp"] = drift + BAR_PP
        out[f"{gain:g}"] = rec
        say(f"capstone {coarse}->{up} gain {gain:g}: (a) {rec['a_max_delta_pp']:.4f} pp, "
            f"(b) {rec['b']['max_delta_pp']:.4f} pp at {rec['b']['repeats']} repeats")
    return out


def git(*args) -> str:
    return subprocess.run(["git", *args], cwd=ROOT, capture_output=True, text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--golden", action="store_true", help="672 -> 1344, the capstone at gain 0.02, float32")
    args = ap.parse_args(argv)
    coarse, up = (672, 1344) if args.golden else (560, 864)
    rec = {"config": {"coarse": coarse, "up": up, "symmetric": True, "weights": "capstone_net(seed 0)",
                      "bias": f"logit-aware, amp {xi.BIAS_AMP:g}, solved on the port's float32 cls_logits (CPU)",
                      "scenes": xi.N_SCENES, "repeats": xi.REPEATS, "sample_n": xi.SAMPLE_N,
                      "estimator": "native RANSAC", "device": "cpu", "torch": torch.__version__,
                      "parity_atol": PARITY_ATOL, "bar_pp": BAR_PP}}
    if not args.golden:
        rec["per_scale_parity"] = per_scale_parity(coarse, up)
    rec["gains"] = capstone(coarse, up, gains=(0.02,) if args.golden else GAINS, jax_bf16=not args.golden)
    report = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            report = json.load(f)
    key = f"{coarse}to{up}"
    report[key] = rec
    # the commit the run started from, and whether the tree held changes to it
    # (a file that records results cannot hold the SHA of its own commit)
    report["git_sha"] = git("rev-parse", "HEAD") or "unknown"
    report["git_tree_changed"] = bool(git("status", "--porcelain", "--", "roma_tpu_torch",
                                          "roma_tpu", "tests", "tools", "native"))
    report["date"] = datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds")
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    say(f"wrote {OUT} [{key}]")
    return report


if __name__ == "__main__":
    main()
