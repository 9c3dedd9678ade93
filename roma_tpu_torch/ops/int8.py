"""Dynamic int8 products of the serving knobs (counterpart of
roma_tpu/ops/int8.py): ``vit_int8`` (DINOv2's proj, fc1 and fc2) and
``refiner_int8`` (the wide refiner stacks' 1x1 convs).

The formula is the JAX package's, step for step, so the port's result is
JAX's bit for bit on the CPU: symmetric per-row activation scales
``max(amax|x|, 1e-12) / 127``, symmetric per-output-column weight scales
from the float32 weight, round half to even, int8, int32 accumulation, then
``acc * sx * sk`` in float32, the float32 bias added, the result cast.

The integer product is ``torch._int_mm`` on both devices (cuBLASLt on the
card), as the JAX package's is XLA's ``dot_general``: no Pallas kernel lies
on this path. On the card ``_int_mm`` takes more than 16 rows and K and N
multiples of 8, with the weight column-major; :func:`padded_int_mm` pads K
and N with zeros (exact in integers) and pads the rows, then slices the
result back. A shape ``_int_mm`` still refuses raises: no int8 path falls
back to a float product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SCALE_FLOOR = 1e-12
QMAX = 127.0
CUDA_MIN_ROWS = 17  # _int_mm on the card takes more than 16 rows
CUDA_ALIGN = 8  # ... and K and N multiples of 8


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize(xf: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``xf`` -> (int8 values, float32 scales kept along ``dim``):
    symmetric, scale ``max(amax|x|, 1e-12) / 127`` over ``dim``. The 127 is
    a tensor: a Python scalar divisor makes the card multiply by its
    rounded reciprocal, which is not the CPU's or XLA's division."""
    amax = xf.abs().amax(dim=dim, keepdim=True).clamp_min(SCALE_FLOOR)
    s = amax / torch.full_like(amax, QMAX)
    return torch.round(xf / s).to(torch.int8), s


def quantize_weight(weight_nk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An (N, K) weight (``nn.Linear``'s layout) -> (int8 (N, K) contiguous,
    float32 scales (1, N)), quantized from its float32 values per output
    column of the (K, N) kernel, as the JAX package's ``sk``."""
    wq, s = quantize(weight_nk.float(), dim=1)
    return wq.contiguous(), s.reshape(1, -1)


def padded_int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(xq, wq.t())`` on operands that the card's
    ``_int_mm`` takes: K and N padded with zeros to multiples of 8 and M to
    more than 16 rows, the weight column-major; the result sliced back to
    (M, N). Exact: the zeros add nothing to an integer sum."""
    m, k = xq.shape
    n = wq.shape[0]
    k8, n8, m8 = _ceil(k, CUDA_ALIGN), _ceil(n, CUDA_ALIGN), max(m, CUDA_MIN_ROWS)
    if (k8, m8) != (k, m):
        xq = F.pad(xq, (0, k8 - k, 0, m8 - m))
    if (k8, n8) != (k, n):
        wq = F.pad(wq, (0, k8 - k, 0, n8 - n))
    acc = torch._int_mm(xq.contiguous(), wq.contiguous().t())
    return acc[:m, :n] if (m8, n8) != (m, n) else acc


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) times the transpose of int8 (N, K) -> int32 (M, N),
    through ``torch._int_mm``: as it is on the CPU, through
    :func:`padded_int_mm` on the card, where each call adds one to
    ``int8_product.launches``. A refusal raises; nothing falls back to a
    float product."""
    if not xq.is_cuda:
        return torch._int_mm(xq, wq.t())
    int8_product.launches += 1
    return padded_int_mm(xq, wq)


int8_product.launches = 0


def int8_matmul_quantized(x: torch.Tensor, wq: torch.Tensor, sk: torch.Tensor,
                          bias: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """``x @ W.T + bias`` with ``(wq, sk)`` from :func:`quantize_weight`:
    x (..., K) in any float dtype quantized per row, int32 accumulation,
    dequantized as ``acc * sx * sk`` in float32, the float32 bias added,
    cast to ``out_dtype`` (default x's) -> (..., N)."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, sx = quantize(x.reshape(-1, k).float(), dim=1)
    out = int8_product(xq, wq).float() * sx * sk
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype or x.dtype).reshape(*lead, wq.shape[0])


def int8_matmul(x: torch.Tensor, weight_kn: torch.Tensor, bias: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """``x @ weight_kn + bias`` through dynamic int8, the JAX package's
    ``int8_matmul(x, kernel, bias, out_dtype)``: weight_kn (K, N) float
    (``nn.Linear.weight.t()``), quantized on each call."""
    wq, sk = quantize_weight(weight_kn.t())
    return int8_matmul_quantized(x, wq, sk, bias, out_dtype)


class QuantizedWeight:
    """A module's int8 weight and scales, made again only when the source
    tensor changed: keyed on its (data_ptr, _version, dtype), so copy_,
    load_state_dict and a cast all requantize (as ConvRefiner.folded_blocks
    refolds). The cache holds the source's storage, so a new storage (a
    cast's, which keeps the parameter's version) cannot take its address
    and pass for it. Made outside inference mode, since match() runs under
    torch.inference_mode and an inference tensor could not be used later
    where autograd is on."""

    def __init__(self):
        self.key, self.value, self.source = None, None, None

    def __call__(self, weight_nk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        key = (weight_nk.data_ptr(), weight_nk._version, weight_nk.dtype)
        if self.key != key:
            with torch.inference_mode(False), torch.no_grad():
                self.source = weight_nk.detach()
                self.key, self.value = key, quantize_weight(self.source)
        return self.value
