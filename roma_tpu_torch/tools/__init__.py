"""Ports of the JAX package's tools/: ``bench_hcw_refiner`` (Kernels I and J
against the model's cuDNN refiner stack) and ``bench_onehot_dots`` (Kernels K
and L) drive the port's graveyard and microbenchmark kernels; their timings
need a CUDA card, and at ``device="cpu"`` their functions compute the same
outputs through the plain versions and time nothing. ``crossimpl`` holds the
cross-implementation capstone's synthetic scenes and seeded weights."""
from __future__ import annotations

import subprocess

import torch


def require_card(device: str):
    """A timed run needs the card: no CPU fallback."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("this benchmark times a CUDA card; torch.cuda.is_available() is false")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after one warm-up."""
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


def timed(fn, device: str, reps: int):
    """(result, ms): ms by :func:`cuda_ms` on the card, None on the CPU."""
    out = fn()
    return out, (cuda_ms(fn, reps) if torch.device(device).type == "cuda" else None)


def fmt_ms(ms) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:9.3f} ms"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]
