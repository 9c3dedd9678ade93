"""Build and load the hand-written CUDA kernels of ``roma_tpu_torch/csrc``.

The kernels are plain C entry points (no PyTorch headers), compiled with
``nvcc`` for ``sm_90a`` at first use into one shared library under
``build/roma_tpu_torch/`` at the repository root, keyed by a hash of the
sources, and loaded with ``ctypes``. Every pointer and the stream go over as
``c_void_p``, every int as ``c_int``. Each entry point launches on the
stream it is given and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.

A build failure raises: nothing here falls back to the plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "roma_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
# per source: ptxas reports each kernel's registers and spills
COMPILE_FLAGS = ["-Xptxas", "-v"]

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry point -> argument types (all return int = cudaError_t); the six L of
# the attention entries are the (batch, head, row) strides of two views
SIGNATURES = {
    "roma_attention_fwd": [P, P, P, P, P, I, I, I, I, I, L, L, L, L, L, L, I, P],
    "roma_attention_bwd": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, L, L, L, L, L, L, I, P],
    "roma_local_corr": [P, P, P, P, I, I, I, I, I, I, I, P],
    "roma_warp_sample": [P, P, P, I, I, I, I, I, I, I, I, P],
    "roma_refiner_block": [P, P, P, P, P, P, I, I, I, I, I, I, P],
    "roma_compact_miss": [P, P, I, I, I, I, P],
    "roma_window_warp": [P] * 10 + [I] * 11 + [P],
    "roma_window_warp_v1": [P] * 10 + [I] * 11 + [P],
    "roma_refiner_chain": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    "roma_wide_refiner_block": [P] * 6 + [I] * 7 + [P],
    "roma_onehot_dot": [P, P, P, P, I, I, I, I, I, I, P],
    "roma_window_sum": [P] * 6 + [I] * 7 + [P],
}

_lib = None
_lock = threading.Lock()


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    return BUILD_DIR / f"libroma_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    return res.stdout + res.stderr


def ptxas_path(library: Path) -> Path:
    """Where a build keeps the compiler's ``-Xptxas -v`` report of the
    library's kernels (registers, spill stores and loads)."""
    return library.with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc per file, in parallel) and link
    them into the hashed shared library, with the ptxas report beside it
    (:func:`ptxas_path`); a no-op when the library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cu, _ = _sources()
    tmp = BUILD_DIR / f"tmp_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    objs = [tmp / (f.stem + ".o") for f in cu]
    with ThreadPoolExecutor(max_workers=len(cu)) as pool:
        logs = list(pool.map(
            lambda fo: _run([nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-I", str(_CSRC), "-c",
                             str(fo[0]), "-o", str(fo[1])]),
            zip(cu, objs),
        ))
    so_tmp = tmp / out.name
    _run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(so_tmp)])
    # the report lands first: a library on disk always has its report
    (tmp / "ptxas.txt").write_text("".join(logs))
    os.replace(tmp / "ptxas.txt", ptxas_path(out))
    os.replace(so_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the current library's kernels, built
    first when needed."""
    return ptxas_path(build()).read_text()


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            dll.roma_error_string.argtypes = [ctypes.c_int]
            dll.roma_error_string.restype = ctypes.c_char_p
            _lib = dll
    return _lib


def check(rc: int, what: str):
    if rc != 0:
        msg = _lib.roma_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream() -> int:
    """The current device's current CUDA stream as a raw handle (the capture
    stream inside a CUDA graph capture). PyTorch's own raw accessor, as its
    generated kernels use it: ``torch.cuda.current_stream().cuda_stream``
    builds a Stream object first, ~8 us of host time a launch on an H100
    host against ~0.2."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32, bfloat16)")
    return DTYPE_CODES[t.dtype]


def require_cuda(what: str, *tensors: torch.Tensor, strided: bool = False):
    """Device and layout checks shared by every kernel wrapper. ``strided``
    admits views whose last dim is contiguous (the kernel takes the other
    strides as arguments); otherwise every tensor must be contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: all tensors must be on one CUDA device")
        if not (t.stride(-1) == 1 if strided else t.is_contiguous()):
            raise ValueError(f"{what}: tensors must be contiguous"
                             + (" in their last dim" if strided else ""))
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{what}: forward-only kernel, no backward")
