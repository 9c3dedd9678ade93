"""The batch-matching engine (counterpart of roma_tpu/serving.py): a stream of
image pairs matched in batches, host preprocessing overlapped with the card.

The reference matches one pair at a time from paths
(romatch/benchmarks/megadepth_pose_estimation_benchmark.py:25-58), leaving
the card idle during every decode and resize. Here:

  * a producer thread decodes and bicubic-resizes each image to the model's
    resolutions (PIL, on a pool of ``WORKERS`` threads), ``PREFETCH``
    batches ahead; it touches no CUDA state;
  * the images cross to the card as uint8, from pinned memory with
    ``non_blocking=True`` on a copy stream, and the match's stream waits on
    the copy's event; the [0, 1] scaling and the ImageNet normalization
    (``normalize=True``) run on the card, as ``RegressionMatcher.match``
    does for a path, so a pair's result is the one ``match`` gives for it in
    a batch. A matcher without a canvas (``TinyRoMa``, which takes [0, 1]
    images) is served with ``resize_hw=(h, w)`` and ``normalize=False``;
  * each batch is one two-pass match of ``batch_size`` pairs: the last,
    short batch is padded with its last pair and those results are dropped;
  * up to ``INFLIGHT`` matched batches may be queued on the card: a CUDA
    event recorded after each batch's match bounds them, and the engine
    waits on the oldest event, never on the whole device.

Example::

    from roma_tpu_torch import roma_outdoor, tiny_roma_v1_outdoor
    from roma_tpu_torch.serving import MatchEngine

    model = roma_outdoor()
    engine = MatchEngine(model, batch_size=8)
    for r in engine.match_paths([("a0.jpg", "b0.jpg"), ("a1.jpg", "b1.jpg")]):
        matches, cert = model.sample(r.warp, r.certainty, num=5000)

    tiny = tiny_roma_v1_outdoor()
    engine = MatchEngine(tiny, batch_size=8, resize_hw=(704, 960), normalize=False)

Results come in input order. ``r.warp`` / ``r.certainty`` are tensors on the
model's device (views into their batch's output); ``on_host=True`` copies
each batch to the host once and yields NumPy arrays. The multi-card engine
(the JAX engine's ``mesh``) is not ported.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from .utils.image import imagenet_normalize, load_image, resize

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


class MatchEngine:
    """Batched dense matcher over a pair stream.

    Args:
      model: a matcher whose ``match(im_A, im_B, [im_A_high_res=,
        im_B_high_res=])`` takes NHWC tensors: a ``RegressionMatcher`` with
        its canvas (``h_resized``, ``w_resized`` and, when it upsamples,
        ``upsample_res``), or a ``TinyRoMa``; its ``device`` and ``dtype``
        (CPU, float32 when it has none) are the inputs'.
      batch_size: pairs a match.
      resize_hw: the (h, w) every image is resized to, for a matcher
        without a canvas (TinyRoMa); a RegressionMatcher defaults to its
        own canvas.
      normalize: ImageNet-normalize on the card. It must agree with the
        model's ``input_normalized`` where it has one (True for a
        RegressionMatcher; False for TinyRoMa, which takes [0, 1] images),
        else a ValueError.
    """

    def __init__(self, model, batch_size: int = 8, resize_hw: tuple[int, int] | None = None,
                 normalize: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")
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
        self.device = torch.device(getattr(model, "device", "cpu"))
        self.dtype = getattr(model, "dtype", torch.float32)
        self._copy_stream = None

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

    def _to_device(self, batch: dict) -> dict:
        """uint8 arrays -> the model's input tensors on its device: through
        pinned memory and the copy stream on a card, ordered before the
        match by an event."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.to(self.device, non_blocking=True) for k, v in pinned.items()}
            copied = self._copy_stream.record_event()
        main = torch.cuda.current_stream(self.device)
        main.wait_event(copied)
        for v in out.values():
            v.record_stream(main)
        return out

    @torch.inference_mode()
    def _dispatch(self, batch: dict):
        """One match of a prepared batch; returns (warp, certainty, event),
        the event recorded after the match on a card, else None."""
        x = {}
        for k, v in self._to_device(batch).items():
            v = v.float() / 255.0
            x[k] = (imagenet_normalize(v) if self.normalize else v).to(self.dtype)
        warp, certainty = self.model.match(x.pop("im_A"), x.pop("im_B"), **x)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return warp, certainty, done

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
        prepped: queue.Queue = queue.Queue(maxsize=PREFETCH)
        err: list[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(WORKERS) as pool:
                    for chunk in chunks:
                        if stop.is_set():
                            break
                        ok, failed, batch = self._prep_batch(pool, chunk)
                        if failed and on_error == "raise":
                            raise MatchEngineError(*failed[0])
                        prepped.put((ok, failed, batch))
            except BaseException as e:  # surfaced on the consumer's side
                err.append(e)
            finally:
                prepped.put(None)

        def drain_one():
            ok, failed, warp, certainty, done = pending.pop(0)
            if done is not None:
                done.synchronize()
            if on_host and warp is not None:
                warp, certainty = warp.cpu().numpy(), certainty.cpu().numpy()
            results = [MatchResult(idx, a, b, warp[i], certainty[i]) for i, (idx, a, b) in enumerate(ok)]
            results += [MatchResult(idx, a, b, None, None, error=e) for idx, a, b, e in failed]
            yield from sorted(results, key=lambda r: r.index)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        pending: list[tuple] = []
        try:
            while True:
                item = prepped.get()
                if item is None:
                    break
                ok, failed, batch = item
                warp = certainty = done = None
                if batch is not None:
                    warp, certainty, done = self._dispatch(batch)
                pending.append((ok, failed, warp, certainty, done))
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
