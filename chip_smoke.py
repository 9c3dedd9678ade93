#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (roma_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from roma_tpu_torch/csrc (nvcc,
   sm_90a) and prints the build time.
2. Checks each kernel against its plain PyTorch version at the shapes the
   560 -> 864 match gives it, in bfloat16 and in float32, and times both
   with CUDA events (median of 20 calls).
3. Checks the whole match on a small configuration: the kernel path on the
   card against the plain path on the CPU, same weights, float32.
4. Builds roma_outdoor at the released widths on seeded random weights
   (bf16 amp, 560 -> 864, symmetric), answers 3 match requests on seeded
   synthetic image pairs, samples 5000 matches from each, and checks shapes,
   finiteness, sample range and that every kernel launched during them.
5. Prints one JSON line of per-kernel results, the card's name and power
   limit, and as the last line {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line is printed. Without a CUDA
device it exits non-zero at once.
"""
from __future__ import annotations

import importlib.metadata
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def require(ok, what: str):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise SmokeFailure(what)

# bf16 check: the kernel and the plain version round to bf16 at the same
# places but sum in another order (and Kernel A keeps the softmax
# probabilities in f32 where the plain version rounds them to bf16), so an
# output may differ by a few bf16 ulps of the largest value.
BF16_REL, BF16_ABS = 3e-2, 1e-2
# f32 check (TF32 off everywhere): only the summation order differs.
F32_REL = 1e-4

KERNEL_INFO = {
    "fused_attention_packed": ("roma_tpu_torch/csrc/attention.cu", "roma_tpu/ops/pallas_attention.py:259"),
    "local_correlation": ("roma_tpu_torch/csrc/local_corr.cu", "roma_tpu/ops/tile_window.py:516"),
    "warp_sample": ("roma_tpu_torch/csrc/warp_sample.cu", "roma_tpu/ops/lane_warp.py:106"),
    "fused_refiner_stack": ("roma_tpu_torch/csrc/refiner_stack.cu", "roma_tpu/ops/pallas_refiner.py:111"),
}


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def smooth_flow(gen, b, h, w, off_band=True):
    """Identity warp + smooth noise, with a band of rows pushed off-image."""
    import torch
    import torch.nn.functional as F

    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device="cuda")
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device="cuda")
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    noise = torch.randn(b, 2, max(h // 8, 2), max(w // 8, 2), generator=gen, device="cuda")
    noise = F.interpolate(noise, size=(h, w), mode="bilinear").permute(0, 2, 3, 1)
    f = torch.stack((gx, gy), -1)[None] + 0.1 * noise
    if off_band:
        f[:, : h // 10, :, 1] -= 2.5
    return f.contiguous()


def kernel_cases(gen, dt):
    """(kernel name, label, kernel call, plain call, rows to compare) per
    main-path shape, inputs of dtype ``dt`` made on the card from ``gen``."""
    import torch

    from roma_tpu_torch import ops

    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
    out = []
    # Kernel A: DINOv2 (16 x 64) and TransformerDecoder (8 x 128) at 560^2,
    # plus the n_valid key mask on a padded sequence
    for label, n, heads, nv in (("dinov2 N1601 16x64", 1601, 16, None),
                                ("decoder N1600 8x128", 1600, 8, None),
                                ("dinov2 N1664 n_valid 1601", 1664, 16, 1601)):
        qkv = 0.5 * rn(2, n, 3 * 1024)
        qkv[:, nv or n:] *= 5.0
        out.append(("fused_attention_packed", label,
                    lambda q=qkv, h=heads, v=nv: ops.fused_attention_packed(q, h, v),
                    lambda q=qkv, h=heads, v=nv: ops.attention_packed_reference(q, h, v),
                    nv or n))
    # Kernel B: every local-correlation scale of both passes, B = 2
    for label, hw, c, r in (("coarse s16 40^2 C512 r7", 40, 512, 7),
                            ("coarse s8 70^2 C512 r3", 70, 512, 3),
                            ("coarse s4 140^2 C256 r2", 140, 256, 2),
                            ("upsample s8 108^2 C512 r3", 108, 512, 3),
                            ("upsample s4 216^2 C256 r2", 216, 256, 2)):
        f0, f1, w = rn(2, hw, hw, c), rn(2, hw, hw, c), smooth_flow(gen, 2, hw, hw)
        out.append(("local_correlation", label,
                    lambda a=f0, b=f1, r=r, w=w: ops.local_correlation(a, b, r, w),
                    lambda a=f0, b=f1, r=r, w=w: ops.local_correlation_reference(a, b, r, w),
                    None))
    # Kernel C: the x_hat lookup at every scale of both passes, B = 2
    for label, hw, c in (("coarse s16 40^2 C512", 40, 512), ("coarse s8 70^2 C512", 70, 512),
                         ("coarse s4 140^2 C256", 140, 256), ("coarse s2 280^2 C64", 280, 64),
                         ("coarse s1 560^2 C9", 560, 9), ("upsample s8 108^2 C512", 108, 512),
                         ("upsample s4 216^2 C256", 216, 256), ("upsample s2 432^2 C64", 432, 64),
                         ("upsample s1 864^2 C9", 864, 9)):
        y, w = rn(2, hw, hw, c), smooth_flow(gen, 2, hw, hw)
        out.append(("warp_sample", label,
                    lambda y=y, w=w: ops.warp_sample(y, w),
                    lambda y=y, w=w: ops.warp_sample_reference(y, w), None))
    # Kernel D: the scale-1 refiner stack, 9 folded blocks of C = 24
    c = 24
    f = lambda *s, scale=1.0, shift=0.0: shift + scale * torch.randn(*s, generator=gen, device="cuda")
    blocks = [ops.fold_block(f(c, 1, 5, 5, scale=0.2), f(c, scale=0.1), f(c, scale=0.1, shift=1.0),
                             f(c, scale=0.1), f(c, scale=0.05), f(c, scale=0.2, shift=1.0).abs(),
                             f(c, c, 1, 1, scale=1.5 / c**0.5), f(c, scale=0.1)) for _ in range(9)]
    for label, hw in (("coarse s1 560^2 C24 x9", 560), ("upsample s1 864^2 C24 x9", 864)):
        x = rn(2, hw, hw, c)
        out.append(("fused_refiner_stack", label,
                    lambda x=x: ops.fused_refiner_stack(x, blocks),
                    lambda x=x: ops.refiner_stack_reference(x, blocks), None))
    return out


def check_kernels(results):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for name, label, kern, plain, rows in kernel_cases(gen, dt):
            k, p = kern(), plain()
            torch.cuda.synchronize()
            k, p = k[:, :rows].float(), p[:, :rows].float()
            require(k.shape == p.shape, f"{name} {label}: shape {tuple(k.shape)} vs {tuple(p.shape)}")
            require(bool(torch.isfinite(k).all()), f"{name} {label}: non-finite kernel output")
            err, scale = (k - p).abs().max().item(), p.abs().max().item()
            if dt == torch.float32:
                tol = F32_REL * max(1.0, scale)
            else:
                tol = BF16_REL * scale + BF16_ABS
            ok = err <= tol
            line = f"{name:24s} {label:30s} {str(dt)[6:]:8s} max|k-p| {err:.3e} (tol {tol:.3e}, max|p| {scale:.3g})"
            r = results[name]
            if dt == torch.bfloat16:
                ms, pms = cuda_ms(kern), cuda_ms(plain)
                r["ms"] += ms
                r["plain_ms"] += pms
                r["max_abs_err"] = max(r["max_abs_err"], err)
                line += f"  kernel {ms:.4f} ms  plain {pms:.4f} ms"
            print(line, flush=True)
            require(ok, f"{name} {label} {dt}: kernel disagrees with its plain version")


def peaked_bias(b, h, w, res, amp=14.0):
    """A peaked anchor-logit field around a smooth warp, so the coarse argmax
    has no near-ties (the role of tools/fullres_parity.py:render_peaked_bias)."""
    import numpy as np

    ys, xs = np.meshgrid(np.linspace(-1 + 1 / h, 1 - 1 / h, h),
                         np.linspace(-1 + 1 / w, 1 - 1 / w, w), indexing="ij")
    a = np.linspace(-1 + 1 / res, 1 - 1 / res, res)
    ay, ax = (g.reshape(-1) for g in np.meshgrid(a, a, indexing="ij"))
    out = np.empty((b, h, w, res * res), np.float32)
    sigma = 2.0 / res
    for i in range(b):
        wx = np.clip(0.9 * xs + 0.05 * (i + 1), -0.98, 0.98)
        wy = np.clip(0.9 * ys - 0.04 * (i + 1), -0.98, 0.98)
        d2 = (wx[..., None] - ax) ** 2 + (wy[..., None] - ay) ** 2
        out[i] = amp * np.exp(-d2 / (2 * sigma * sigma))
    return out


def check_small_match():
    """The whole match on a small configuration: kernels on the card against
    the plain versions on the CPU, one set of weights, float32."""
    import copy

    import numpy as np
    import torch

    from roma_tpu_torch.models import RegressionMatcher, RoMaConfig
    from roma_tpu_torch.models.zoo import build_net, init_random

    # RoMaConfig.tiny() with head dims of 64, which Kernel A takes
    cfg = RoMaConfig(
        vgg_channels=((8, 8), (16, 16), (16, 16, 16, 16), (24, 24, 24, 24)),
        dino_dim=128, dino_depth=2, dino_heads=2, gp_dim=64, cls_res=16,
        decoder_depth=2, decoder_heads=2,
        proj_out=((16, 64), (8, 16), (4, 16), (2, 16), (1, 9)),
        disp_emb=((16, 8), (8, 8), (4, 8), (2, 8), (1, 6)),
        corr_radius=((16, 7), (8, 3), (4, 2), (2, 0), (1, 0)), hidden_blocks=2,
    )
    net = init_random(build_net(cfg, "cpu"), seed=1, std=0.1).eval()
    rs = np.random.RandomState(2)
    a, b = (rs.randn(112, 112, 3).astype(np.float32) for _ in range(2))
    bias = peaked_bias(2, 8, 8, cfg.cls_res)
    outs = []
    for dev, n in (("cpu", net), ("cuda", copy.deepcopy(net).to("cuda"))):
        m = RegressionMatcher(n, h=112, w=112, upsample_res=(128, 128))
        w, c = m.match(a, b, gm_logit_bias=bias)
        outs.append((w.cpu(), c.cpu()))
    (wc, cc), (wg, cg) = outs
    ew, ec = (wg - wc).abs().max().item(), (cg - cc).abs().max().item()
    print(f"small match 112->128 f32: cuda kernels vs cpu plain: warp {ew:.3e} certainty {ec:.3e}", flush=True)
    require(wg.shape == (128, 256, 4) and ew <= 1e-3 and ec <= 1e-3, "small-config match disagrees")


def synthetic_pair(seed: int, hw=(720, 960)):
    """A textured image and a warped copy of it (rotation, scale, shift)."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(60):
        cy, cx, r = rs.uniform(0, h), rs.uniform(0, w), rs.uniform(10, 80)
        img += rs.uniform(0, 1, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
    img += 0.15 * np.sin(xx / rs.uniform(5, 20))[..., None] * np.cos(yy / rs.uniform(5, 20))[..., None]
    img = np.clip(img / img.max(), 0, 1)
    im_a = Image.fromarray((img * 255).astype(np.uint8))
    im_b = im_a.rotate(rs.uniform(-15, 15), resample=Image.BICUBIC,
                       translate=(rs.uniform(-40, 40), rs.uniform(-40, 40)))
    return im_a, im_b


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    sys.path.insert(0, HERE)
    from roma_tpu_torch import _ext
    from roma_tpu_torch.models.zoo import roma_outdoor
    from roma_tpu_torch.ops import KERNEL_WRAPPERS

    card = smi_line()
    nvcc = subprocess.run([_ext.nvcc_path(), "--version"], capture_output=True, text=True).stdout
    try:  # reported only: the port's kernels are CUDA C++
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"nvcc {nvcc.strip().splitlines()[-1]}  triton {triton}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _ext.build(verbose=True)  # prints ptxas registers / spills per kernel
    _ext.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_ext.library_path().relative_to(HERE)})", flush=True)

    results = {
        name: {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": 0,
               "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        for name, (src, rep) in KERNEL_INFO.items()
    }
    check_kernels(results)
    check_small_match()

    t0 = time.perf_counter()
    model = roma_outdoor(device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.net.parameters())
    print(f"roma_outdoor(560 -> 864, bf16 amp, symmetric): {n_params} parameters, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    pairs = [synthetic_pair(seed) for seed in range(3)]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    latencies = []
    for f in KERNEL_WRAPPERS:
        f.launches = 0
    for im_a, im_b in pairs:
        t0 = time.perf_counter()
        warp, cert = model.match(im_a, im_b)
        matches, mcert = model.sample(warp, cert, num=5000, generator=gen)
        kpts_a, kpts_b = model.to_pixel_coordinates(matches, im_a.height, im_a.width, im_b.height, im_b.width)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        require(tuple(warp.shape) == (864, 1728, 4), f"warp shape {tuple(warp.shape)}")
        require(tuple(cert.shape) == (864, 1728), f"certainty shape {tuple(cert.shape)}")
        require(bool(torch.isfinite(warp).all() and torch.isfinite(cert).all()), "non-finite match output")
        require(tuple(matches.shape) == (5000, 4) and matches.abs().max().item() <= 1.0,
                "samples must be (5000, 4) in [-1, 1]")
        require(bool(torch.isfinite(kpts_a).all() and torch.isfinite(kpts_b).all()), "non-finite keypoints")
    launches = {f.__name__: f.launches for f in KERNEL_WRAPPERS}
    for name, n in launches.items():
        results[name]["launches"] = n
    print(f"kernel launches during the 3 requests: {launches}")
    peak = torch.cuda.max_memory_allocated()
    print("request latency s: " + " ".join(f"{t:.4f}" for t in latencies))
    print(f"pairs/s after the first request: {(len(latencies) - 1) / sum(latencies[1:]):.4f}")
    print(f"peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB)")
    print(f"certainty mean {cert.mean().item():.4f}, warp range [{warp.min().item():.3f}, {warp.max().item():.3f}]")
    missing = [n for n, c in launches.items() if c == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")

    torch.cuda.synchronize()
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
