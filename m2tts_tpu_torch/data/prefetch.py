"""Background batch preparation and the host→device copy of a batch.

``DevicePrefetcher`` is a copy of ``m2tts_tpu/data/prefetch.py``: one
daemon thread runs ``put_fn`` (collation, dtype casts, the device copy)
ahead of the consumer, ``depth`` batches deep, and re-raises any error at
the consumer's ``next()``. The port adds ``ready_fn``, run in the consumer's
thread on each batch before it is handed out.

``BatchTransfer`` is the ``put_fn``/``ready_fn`` pair for a device. On CUDA
``put`` pins each host array and copies it with ``non_blocking=True`` on a
side stream, then records an event; ``ready`` makes the consumer's current
stream wait for that event and ``record_stream``s every tensor on it.
Without both, the consumer's kernels could read a batch before its copy
lands, and the caching allocator could hand a batch's memory (allocated on
the side stream) to the next copy while those kernels still read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_OK, _DONE, _ERROR = 0, 1, 2

# the float arrays transfer_dtype applies to (audio_seg: stage 2's targets)
TRANSFER_KEYS = ("mel", "audio", "audio_seg")


class DevicePrefetcher:
    """Wrap a batch iterator; apply ``put_fn`` ahead of the consumer.

    Iterator protocol: yields ``ready_fn(put_fn(batch))`` in source order,
    raises StopIteration on exhaustion, re-raises any source/``put_fn``
    exception at the consumer's ``next()`` call. ``close()`` stops the
    worker thread (needed for infinite sources).
    """

    def __init__(self, source: Iterator[Any], put_fn: Callable[[Any], Any],
                 depth: int = 2,
                 ready_fn: Optional[Callable[[Any], Any]] = None):
        self._source = source
        self._put_fn = put_fn
        self._ready_fn = ready_fn
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetcher")
        self._thread.start()

    def _enqueue(self, item) -> None:
        # bounded put that aborts promptly on close()
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _worker(self) -> None:
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                out = self._put_fn(batch)
                self._enqueue((_OK, out))
                if self._stop.is_set():
                    return
            self._enqueue((_DONE, None))
        except BaseException as e:  # propagate to the consumer thread
            self._enqueue((_ERROR, e))

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._finished:
            raise StopIteration
        # bounded get: a consumer racing with (or arriving after) close()
        # must see StopIteration, not block forever on an empty queue the
        # stopped worker will never refill
        while True:
            try:
                kind, payload = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._finished = True
                    raise StopIteration from None
        if kind == _OK:
            return payload if self._ready_fn is None else self._ready_fn(payload)
        self._finished = True
        if kind == _ERROR:
            raise payload
        raise StopIteration

    def close(self) -> None:
        """Stop the worker (drains the queue so a blocked put unblocks,
        then leaves a _DONE sentinel so any late consumer wakes)."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        try:
            self._queue.put_nowait((_DONE, None))
        except queue.Full:  # worker refilled it; consumer still unblocks
            pass
        self._thread.join(timeout=5.0)


InFlight = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


class BatchTransfer:
    """Host batch (dict of numpy arrays) → dict of tensors on ``device``.

    0-d entries (``n_valid``) stay on the host. With ``transfer_dtype`` the
    float32 ``TRANSFER_KEYS`` arrays are cast on the host by torch
    (round to nearest even) before the copy, halving its bytes for bf16.
    ``put`` may run in any thread; ``ready`` runs in the thread whose
    current stream consumes the batch. ``transfer(batch)`` does both.
    """

    def __init__(self, device, transfer_dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        self.transfer_dtype = transfer_dtype
        self._stream: Optional[torch.cuda.Stream] = None

    def put(self, batch: Dict[str, Any]) -> InFlight:
        host = {}
        for k, v in batch.items():
            if not (hasattr(v, "ndim") and v.ndim > 0):
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if (self.transfer_dtype is not None and k in TRANSFER_KEYS
                    and t.dtype == torch.float32):
                t = t.to(self.transfer_dtype)
            host[k] = t
        if self.device.type != "cuda":
            return {k: t.to(self.device) for k, t in host.items()}, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def ready(self, inflight: InFlight) -> Dict[str, torch.Tensor]:
        tensors, done = inflight
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors

    def transfer(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.ready(self.put(batch))
