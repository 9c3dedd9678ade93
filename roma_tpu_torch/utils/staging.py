"""Host arrays to a device: :class:`PinnedStaging`, the one way the port takes
for ``RegressionMatcher``'s input prep, ``MatchEngine`` and the loader's
``to_device``."""
from __future__ import annotations

import threading

import numpy as np
import torch


class PinnedStaging:
    """On a CUDA device the arrays are packed into one pinned host buffer,
    reused and grown as needed, and cross in one copy on the device's copy
    stream, which does not queue behind work already on the current stream.
    The current stream waits on the copy's event, and the device memory,
    fresh each call, is marked as used by it (``record_stream``) so that no
    later copy is handed it while the current stream may still read it. The
    buffer is written again only after the copy out of it has completed, so
    calls with no synchronization between them cannot overwrite a copy in
    flight; a lock lets one thread at a time use it. Elsewhere nothing is
    pinned: each array is ``torch.from_numpy(...).to(device)``."""

    def __init__(self):
        self._buf, self._copied = None, None  # the pinned buffer; an event after the last copy out of it
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._lock = threading.Lock()

    def to_device(self, arrays, device, stack: bool = False):
        """NumPy ``arrays`` of any dtype as tensors on ``device`` of their
        dtypes and shapes: a list, or with ``stack=True`` one contiguous
        tensor ``(len(arrays), *shape)`` of arrays of one shape and dtype."""
        device = torch.device(device)
        arrays = [np.asarray(a, order="C") for a in arrays]
        if stack and len({(a.shape, a.dtype) for a in arrays}) > 1:
            raise ValueError(f"stack=True needs arrays of one shape and dtype, got "
                             f"{[(a.shape, str(a.dtype)) for a in arrays]}")
        if device.type != "cuda":
            if stack:
                return torch.from_numpy(np.stack(arrays)).to(device)
            return [torch.from_numpy(a if a.flags.writeable else a.copy()).to(device) for a in arrays]
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        offsets, n = [], 0
        for a in arrays:
            n += -n % a.itemsize  # each array at an offset aligned for its dtype
            offsets.append(n)
            n += a.nbytes
        with self._lock:
            if self._copied is not None:
                self._copied.synchronize()
            if self._buf is None or self._buf.numel() < n:
                self._buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            for a, at in zip(arrays, offsets):
                self._buf.numpy()[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream(device)
            copy, main = self._streams[device], torch.cuda.current_stream(device)
            with torch.cuda.stream(copy):
                flat = self._buf[:n].to(device, non_blocking=True)
                self._copied = copy.record_event()
            main.wait_event(self._copied)
            flat.record_stream(main)
        dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in arrays]
        if stack:
            return flat.view(dtypes[0]).view(len(arrays), *arrays[0].shape)
        return [flat[at:at + a.nbytes].view(t).view(a.shape) for a, at, t in zip(arrays, offsets, dtypes)]
