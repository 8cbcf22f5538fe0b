"""Dynamic request batching for the HTTP server.

Counterpart of ``m2tts_tpu/serving/batcher.py``. A batch of many
utterances costs the device barely more than one, so serving concurrent
single-utterance requests one by one leaves most of it idle.
``DynamicBatcher`` coalesces concurrent ``submit()`` calls into one
``Synthesizer.synthesize_batch`` call: the first arrival opens a
collection window of ``max_wait_ms``, stragglers inside it join up to
``max_batch``, and requests are grouped per ``(duration_scale,
pcm_format)`` (one call takes one of each). Results go back to the
blocked request threads; a failed call sends its exception to every caller
of that group, so a bad batch never strands its callers.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("text", "scale", "pcm_format", "event", "result", "error")

    def __init__(self, text: str, scale: float, pcm_format: str = "int16"):
        self.text = text
        self.scale = scale
        self.pcm_format = pcm_format
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Coalesce concurrent synthesize requests into batched calls.

    ``synth``: the shared ``Synthesizer``. ``lock``: the device lock shared
    with the server's other routes; the worker holds it around each call.
    ``max_batch``: the largest batch a call takes (default: the largest
    batch bucket). ``max_wait_ms``: the straggler window the first queued
    request opens; it bounds the latency a request pays for batching.
    """

    def __init__(self, synth, lock: Optional[threading.Lock] = None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: float = 10.0):
        self.synth = synth
        self.lock = lock if lock is not None else threading.Lock()
        self.max_batch = int(max_batch or max(synth.batch_buckets))
        self.max_wait = float(max_wait_ms) / 1000.0
        self._q: "queue.SimpleQueue[Optional[_Pending]]" = queue.SimpleQueue()
        self._closed = False
        # the closed check and the enqueue happen under one lock, so no
        # request can land behind the close sentinel and wait forever
        self._submit_mu = threading.Lock()
        self.requests_served = 0
        self.batches_run = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dynamic-batcher")
        self._worker.start()

    def submit(self, text: str, duration_scale: float = 1.0,
               timeout: Optional[float] = None,
               pcm_format: str = "int16") -> Dict[str, Any]:
        """Block until the request's result is ready. Texts over the
        phoneme budget belong to ``synthesize_long`` (they need splitting,
        not batching)."""
        p = _Pending(text, float(duration_scale), pcm_format)
        with self._submit_mu:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError(f"synthesis not ready within {timeout}s")
        if p.error is not None:
            raise p.error
        if p.result is None:
            raise RuntimeError("batched synthesis returned no result")
        return p.result

    def close(self) -> None:
        """Stop the worker. Everything enqueued before the close still
        runs: the worker stops only at the sentinel, and nothing lands
        behind it."""
        with self._submit_mu:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=30)

    def _drain_window(self, first: _Pending) -> Tuple[List[_Pending], bool]:
        """Collect stragglers for up to max_wait; (batch, stop)."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                return batch, True
            batch.append(item)
        return batch, False

    def _run(self) -> None:
        # grad mode is per thread: this worker's device work must not
        # record autograd graphs
        with torch.inference_mode():
            stop = False
            while not stop:
                first = self._q.get()
                if first is None:
                    return
                batch, stop = self._drain_window(first)
                by_key: Dict[tuple, List[_Pending]] = {}
                for p in batch:
                    by_key.setdefault((p.scale, p.pcm_format), []).append(p)
                for (scale, fmt), group in by_key.items():
                    self._run_group(scale, fmt, group)

    def _run_group(self, scale: float, fmt: str,
                   group: List[_Pending]) -> None:
        try:
            with self.lock:
                results = self.synth.synthesize_batch(
                    [p.text for p in group], scale, pcm_format=fmt)
            self.batches_run += 1
            self.requests_served += len(group)
            for p, r in zip(group, results):
                p.result = r
        except Exception as e:  # fan the failure back out to the callers
            logger.exception("batched synthesis failed (%d requests)",
                             len(group))
            for p in group:
                p.error = e
        finally:
            for p in group:
                p.event.set()
