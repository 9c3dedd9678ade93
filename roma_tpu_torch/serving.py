"""The batch-matching engine (counterpart of roma_tpu/serving.py): a stream of
image pairs matched in batches, host preprocessing overlapped with the card.

The reference matches one pair at a time from paths
(romatch/benchmarks/megadepth_pose_estimation_benchmark.py:25-58), leaving
the card idle during every decode and resize. Here:

  * a producer thread decodes and bicubic-resizes each image to the model's
    resolutions (PIL, on a pool of ``WORKERS`` threads), ``PREFETCH``
    batches ahead; it touches no CUDA state;
  * the images cross to the card as uint8 through ``utils.staging`` (a
    reused pinned buffer, one copy a batch on the device's copy stream, which
    the match's stream waits on); the [0, 1] scaling and the ImageNet
    normalization (``normalize=True``) run on the card, as
    ``RegressionMatcher.match`` does for a path, so a pair's result is the
    one ``match`` gives for it in a batch. A matcher without a canvas (``TinyRoMa``, which takes [0, 1]
    images) is served with ``resize_hw=(h, w)`` and ``normalize=False``;
  * each batch is one two-pass match of ``batch_size`` pairs: the last,
    short batch is padded with its last pair and those results are dropped;
  * up to ``INFLIGHT`` matched batches may be queued on the card: a CUDA
    event recorded after each batch's match bounds them, and the engine
    waits on the oldest event, never on the whole device;
  * its spans (``utils.profiling``), one unit a batch: ``roma.engine.prep``
    on the producer thread (decode and resize of a batch),
    ``roma.engine.wait`` (the consumer blocked on the prepared batches),
    ``roma.engine.dispatch`` (the copy and scaling, ``roma.engine.to_device``,
    and the match's enqueue) and ``roma.engine.gather`` (the wait for a
    batch's events);
  * with ``devices=[d0, d1, ...]`` (the JAX engine's ``mesh``) each device
    holds a replica of the model and each batch is split into
    ``len(devices)`` contiguous shards, one a replica: each shard crosses
    to its device on that device's copy stream, is matched there, and its
    event bounds that device's queue. The results are gathered on
    ``devices[0]``.

Example::

    from roma_tpu_torch import roma_outdoor, tiny_roma_v1_outdoor
    from roma_tpu_torch.serving import MatchEngine

    model = roma_outdoor()
    engine = MatchEngine(model, batch_size=8)
    for r in engine.match_paths([("a0.jpg", "b0.jpg"), ("a1.jpg", "b1.jpg")]):
        matches, cert = model.sample(r.warp, r.certainty, num=5000)

    tiny = tiny_roma_v1_outdoor()
    engine = MatchEngine(tiny, batch_size=8, resize_hw=(704, 960), normalize=False)

    engine = MatchEngine(model, batch_size=8, devices=get_devices(2))  # parallel.get_devices

Results come in input order. ``r.warp`` / ``r.certainty`` are tensors on the
model's device, or on ``devices[0]`` (views into their shard's output);
``on_host=True`` copies each shard to the host once and yields NumPy arrays.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from .utils.image import imagenet_normalize, load_image, resize
from .utils.profiling import annotate, new_units
from .utils.staging import PinnedStaging

# host batches prepared ahead of the match, matched batches queued on the card
# before the engine waits for the oldest (bounds device memory), and decode /
# resize threads
PREFETCH, INFLIGHT, WORKERS = 2, 2, 8


@dataclasses.dataclass
class MatchResult:
    """One matched pair: its index in the input stream and the dense
    outputs. With ``on_error="skip"`` a pair that failed preprocessing has
    ``warp is None`` and ``error`` set."""

    index: int
    im_A: object
    im_B: object
    warp: object       # (H, W, 4), or (H, 2W, 4) symmetric: the model's layout
    certainty: object
    error: BaseException | None = None


class MatchEngineError(RuntimeError):
    """A pair failed host preprocessing; names the input."""

    def __init__(self, index: int, im_A, im_B, cause: BaseException):
        def name(x):
            return x if isinstance(x, str) else type(x).__name__

        super().__init__(f"pair {index} ({name(im_A)!r}, {name(im_B)!r}) failed preprocessing: {cause!r}")
        self.index = index
        self.cause = cause


def _prep(im, hw) -> np.ndarray:
    """Decode and bicubic-resize on the host: (h, w, 3) uint8."""
    return np.asarray(resize(load_image(im), hw), np.uint8)


def _device(d) -> torch.device:
    """A device with its index: a bare "cuda" names the current card."""
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


def _replica(model, device: torch.device):
    """A copy of ``model`` whose net was moved to ``device`` (its generator
    remade there with the same seed)."""
    r = copy.copy(model)
    r.net = copy.deepcopy(model.net).to(device)
    r.device = device
    r.generator = torch.Generator(device=device).manual_seed(model.generator.initial_seed())
    return r


class MatchEngine:
    """Batched dense matcher over a pair stream.

    Args:
      model: a matcher whose ``match(im_A, im_B, [im_A_high_res=,
        im_B_high_res=])`` takes NHWC tensors: a ``RegressionMatcher`` with
        its canvas (``h_resized``, ``w_resized`` and, when it upsamples,
        ``upsample_res``), or a ``TinyRoMa``; its ``device`` and ``dtype``
        (CPU, float32 when it has none) are the inputs'.
      batch_size: pairs a batch, split evenly over ``devices``.
      devices: the devices to match on, one replica each (e.g.
        ``parallel.get_devices()``); the first replica is ``model`` itself
        when it sits on ``devices[0]``. ``batch_size`` must divide by their
        number. Default: the model's device alone.
      resize_hw: the (h, w) every image is resized to, for a matcher
        without a canvas (TinyRoMa); a RegressionMatcher defaults to its
        own canvas.
      normalize: ImageNet-normalize on the card. It must agree with the
        model's ``input_normalized`` where it has one (True for a
        RegressionMatcher; False for TinyRoMa, which takes [0, 1] images),
        else a ValueError.
    """

    def __init__(self, model, batch_size: int = 8, devices=None, resize_hw: tuple[int, int] | None = None,
                 normalize: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")
        own = _device(getattr(model, "device", "cpu"))
        devices = [own] if devices is None else [_device(d) for d in devices]
        if not devices or batch_size % len(devices):
            raise ValueError(f"batch_size {batch_size} must divide across the {len(devices)} devices")
        if resize_hw is None and not hasattr(model, "h_resized"):
            raise ValueError("model has no built-in canvas (h_resized / w_resized); pass resize_hw=(h, w), e.g. "
                             "MatchEngine(tiny, resize_hw=(448, 640), normalize=False)")
        if getattr(model, "input_normalized", normalize) != normalize:
            raise ValueError(f"normalize={normalize} but {type(model).__name__} takes "
                             f"{'ImageNet-normalized' if model.input_normalized else '[0, 1]'} images")
        self.model = model
        self.batch_size = batch_size
        self.resize_hw = None if resize_hw is None else tuple(resize_hw)
        self.normalize = normalize
        self.devices = devices
        self.replicas = [model if i == 0 and d == own else _replica(model, d) for i, d in enumerate(devices)]
        self.dtype = getattr(model, "dtype", torch.float32)
        self._staging = PinnedStaging()

    def _resolutions(self):
        if self.resize_hw is not None:
            return self.resize_hw, None
        m = self.model
        up_hw = tuple(m.upsample_res) if getattr(m, "upsample_preds", False) else None
        return (m.h_resized, m.w_resized), up_hw

    def _prep_batch(self, pool: ThreadPoolExecutor, chunk: Sequence[tuple]):
        """Decode and resize a chunk of (index, im_A, im_B) on the pool ->
        (ok, failed, batch): the pairs that went through, the (index, im_A,
        im_B, exception) of those that did not, and the uint8 NHWC arrays
        padded to batch_size (None when no pair went through)."""
        coarse_hw, up_hw = self._resolutions()
        hws = (coarse_hw,) if up_hw is None else (coarse_hw, up_hw)
        jobs = [[pool.submit(_prep, im, hw) for hw in hws for im in (a, b)] for _, a, b in chunk]
        ok, failed, outs = [], [], []
        for pair, per_pair in zip(chunk, jobs):
            try:
                outs.append([j.result() for j in per_pair])
                ok.append(pair)
            except Exception as e:  # a corrupt file, a bad shape, an IO error, ...
                failed.append((*pair, e))
        if not ok:
            return ok, failed, None
        outs = outs + [outs[-1]] * (self.batch_size - len(outs))
        names = ("im_A", "im_B", "im_A_high_res", "im_B_high_res")
        return ok, failed, {n: np.stack([o[k] for o in outs]) for k, n in enumerate(names[:len(outs[0])])}

    @torch.inference_mode()
    def _dispatch(self, batch: dict) -> list[tuple]:
        """One match a shard of a prepared batch, on its replica's device;
        returns a (warp, certainty, event) a shard, the event recorded
        after the match on a card, else None."""
        n = self.batch_size // len(self.replicas)
        out = []
        for i, (model, device) in enumerate(zip(self.replicas, self.devices)):
            shard = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                x = {}
                with annotate("roma.engine.to_device"):
                    for k, v in zip(shard, self._staging.to_device(list(shard.values()), device)):
                        v = v.float() / 255.0
                        x[k] = (imagenet_normalize(v) if self.normalize else v).to(self.dtype)
                warp, certainty = model.match(x.pop("im_A"), x.pop("im_B"), **x)
                done = None
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(device))
            out.append((warp, certainty, done))
        return out

    def _gather(self, shards: list[tuple], on_host: bool) -> list[tuple]:
        """Wait for each shard's match; its (warp, certainty) rows in batch
        order, views on ``devices[0]``, or NumPy arrays (one copy a shard)."""
        rows = []
        for warp, certainty, done in shards:
            if done is not None:
                done.synchronize()
            if on_host:
                warp, certainty = warp.cpu().numpy(), certainty.cpu().numpy()
            else:
                warp, certainty = warp.to(self.devices[0]), certainty.to(self.devices[0])
            rows += zip(warp, certainty)
        return rows

    def match_paths(self, pairs: Iterable[tuple], *, on_host: bool = False,
                    on_error: str = "raise") -> Iterator[MatchResult]:
        """Match a stream of (im_A, im_B) pairs (paths, PIL images or HWC
        arrays: anything ``utils.image.load_image`` takes); yields
        ``MatchResult`` in input order.

        ``on_host=True`` yields NumPy arrays (one device-to-host copy a
        batch). ``on_error``: ``"raise"`` raises :class:`MatchEngineError`
        naming the first pair that failed preprocessing; ``"skip"`` yields
        it as ``MatchResult(warp=None, certainty=None, error=exc)`` in
        order. Either way the other pairs of its batch still match."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
        indexed = [(i, a, b) for i, (a, b) in enumerate(pairs)]
        if not indexed:
            return
        chunks = [indexed[i:i + self.batch_size] for i in range(0, len(indexed), self.batch_size)]
        first_unit = new_units(len(chunks) + 1)  # batch k's spans share first_unit + k; the last wait, one more
        prepped: queue.Queue = queue.Queue(maxsize=PREFETCH)
        err: list[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(WORKERS) as pool:
                    for k, chunk in enumerate(chunks):
                        if stop.is_set():
                            break
                        with annotate("roma.engine.prep", unit=first_unit + k):
                            ok, failed, batch = self._prep_batch(pool, chunk)
                        if failed and on_error == "raise":
                            raise MatchEngineError(*failed[0])
                        prepped.put((ok, failed, batch))
            except BaseException as e:  # surfaced on the consumer's side
                err.append(e)
            finally:
                prepped.put(None)

        def drain_one():
            unit, ok, failed, shards = pending.pop(0)
            with annotate("roma.engine.gather", unit=unit):
                rows = self._gather(shards, on_host) if shards else []
            results = [MatchResult(idx, a, b, *rows[i]) for i, (idx, a, b) in enumerate(ok)]
            results += [MatchResult(idx, a, b, None, None, error=e) for idx, a, b, e in failed]
            yield from sorted(results, key=lambda r: r.index)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        pending: list[tuple] = []
        try:
            unit = first_unit
            while True:
                with annotate("roma.engine.wait", unit=unit):
                    item = prepped.get()
                if item is None:
                    break
                ok, failed, batch = item
                with annotate("roma.engine.dispatch", unit=unit):
                    shards = None if batch is None else self._dispatch(batch)
                pending.append((unit, ok, failed, shards))
                unit += 1
                if len(pending) > INFLIGHT:
                    yield from drain_one()
            while pending:
                yield from drain_one()
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    prepped.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
