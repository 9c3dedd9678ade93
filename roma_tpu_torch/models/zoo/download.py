"""Pretrained-weight download and cache (counterpart of
roma_tpu/models/zoo/download.py): stdlib urllib into ``ROMA_TPU_CACHE``
(default ``~/.cache/roma_tpu``), the cache the JAX package uses, so the two
packages share each downloaded file.

Without a network every entry point comes up on seeded random weights: the
first connection that fails flips a process-wide flag, and later calls skip
straight to the offline path without paying the timeout again.
``ROMA_TPU_OFFLINE=1`` skips every download.
"""
from __future__ import annotations

import os
import sys
import urllib.error
import urllib.request

_CACHE_ENV = "ROMA_TPU_CACHE"
_OFFLINE_ENV = "ROMA_TPU_OFFLINE"  # set to skip every download
TIMEOUT_S = 10.0  # a connection that opens no faster is taken as no network

#: None = unknown, True/False = the outcome of the first real attempt
_egress_ok: bool | None = None


def cache_dir() -> str:
    return os.environ.get(_CACHE_ENV) or os.path.join(os.path.expanduser("~"), ".cache", "roma_tpu")


def download_available() -> bool:
    """False once the environment says offline or a first attempt failed."""
    if os.environ.get(_OFFLINE_ENV):
        return False
    return _egress_ok is not False


def fetch(url: str) -> str | None:
    """Download ``url`` into the cache (written to a ``.part`` file, then
    renamed) and return the local path, with its progress on stderr; a
    cached file is returned at once. Returns None, and marks the process
    offline, when no connection can be made; a transfer that breaks after
    bytes flowed raises, and no partial file is kept."""
    global _egress_ok
    path = os.path.join(cache_dir(), url.rsplit("/", 1)[-1])
    if os.path.exists(path):
        return path
    if not download_available():
        return None
    os.makedirs(cache_dir(), exist_ok=True)
    tmp = path + ".part"
    done = 0
    try:
        req = urllib.request.Request(url, headers={"User-Agent": "roma-tpu"})
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r, open(tmp, "wb") as f:
            total = int(r.headers.get("Content-Length") or 0)
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
                done += len(chunk)
                if total:
                    print(f"\r  {url.rsplit('/', 1)[-1]}: {done / 1e6:.0f}/{total / 1e6:.0f} MB", end="",
                          file=sys.stderr, flush=True)
        print(file=sys.stderr)
        os.replace(tmp, path)
        _egress_ok = True
        return path
    except (urllib.error.URLError, TimeoutError, ConnectionError, OSError) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        # bytes flowed in this attempt: a real error, never a silent random
        # init after a download that almost finished
        if done > 0 or _egress_ok:
            raise
        _egress_ok = False
        print(f"roma_tpu_torch: weight download unavailable ({e}); models come up randomly initialized. Pass "
              "local checkpoint paths (weights=..., dinov2_weights=...) for pretrained runs.", file=sys.stderr)
        return None
