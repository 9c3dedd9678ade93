"""The device list of one process (counterpart of roma_tpu/parallel/mesh.py:
get_mesh): the cards ``MatchEngine(devices=)`` puts one replica each on."""
from __future__ import annotations

import torch


def get_devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` CUDA devices (all of them by default); raises when
    the process sees fewer."""
    count = torch.cuda.device_count()
    n = count if n is None else n
    if n < 1 or n > count:
        raise RuntimeError(f"get_devices: {n} CUDA devices asked for, {count} visible")
    return [torch.device("cuda", i) for i in range(n)]
