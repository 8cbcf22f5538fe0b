"""Multi-stream batching for the streaming synthesis path.

Counterpart of ``m2tts_tpu/serving/stream_batcher.py``. A solo stream
vocodes one chunk window a call at batch 1, so N concurrent streams cost N
small calls per chunk interval. Every stream's window has the same shape
wherever it is in its utterance, so the active streams can share one
batched vocoder call per tick: stack their windows, run the chunk function
once at a padded batch bucket, hand each stream its slice.

Two coalescing stages:

- **Admission**: concurrent ``stream()`` calls' acoustic passes are
  collected for ``max_wait_ms`` and run as one batched call per duration
  scale. The mel stays on the device; the admission worker fetches only
  the frame counts and activates the streams.
- **Chunking**: a scheduler thread takes up to ``max_streams`` active
  streams a tick (round-robin when more are active), stacks their windows
  on the device and makes one vocoder call.

The chunk function treats every batch row alone, so batched windows give
each stream what its solo stream gives (``StreamingSynthesizer.stream``).
Both workers run under ``torch.inference_mode`` in their own threads, and
every device call goes through the shared ``lock``. On CUDA each call is a
replay of the streamer's graph for its batch bucket (``utils/graphs.py``).

The batcher counts its work in plain integers, always on:
``streams_served``, ``chunk_dispatches`` and ``chunks_emitted`` (the
scheduler), ``admit_passes`` and ``admitted`` (acoustic passes and the
requests they admitted), ``lock_acquires`` and ``lock_wait_ns`` (its
acquisitions of the shared device lock and the time spent waiting for
them). Its spans (``stream.*``) are ``utils/profiling.py``'s, recorded
while tracing is on.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from m2tts_tpu_torch.utils.profiling import record, span, tracing

logger = logging.getLogger(__name__)

_BUCKETS = (1, 2, 4, 8, 16)


def _bucket(n: int, cap: int) -> int:
    for b in _BUCKETS:
        if b >= n:
            return min(b, cap)
    return cap


class _Active:
    """One mid-flight stream: its device mel, chunk cursor and output
    queue."""

    __slots__ = ("mel", "frames", "ci", "n_chunks", "out")

    def __init__(self, mel: torch.Tensor, frames: int, n_chunks: int):
        self.mel = mel
        self.frames = frames
        self.ci = 0
        self.n_chunks = n_chunks
        # ("chunk" | "done" | "error", payload); unbounded, so a stalled
        # consumer never blocks the shared scheduler (an utterance of
        # chunks is small)
        self.out: queue.SimpleQueue = queue.SimpleQueue()


class _DeviceLock:
    """The shared device lock as the batcher takes it: each acquisition
    adds its wait to the owner's ``lock_wait_ns`` and ``lock_acquires``
    (under the lock, so threads never race on them) and, while tracing is
    on, records a ``stream.lock_wait`` span."""

    __slots__ = ("owner", "lock")

    def __init__(self, owner: "StreamBatcher"):
        self.owner, self.lock = owner, owner.lock

    def __enter__(self) -> None:
        t0 = time.perf_counter_ns()
        self.lock.acquire()
        t1 = time.perf_counter_ns()
        self.owner.lock_wait_ns += t1 - t0
        self.owner.lock_acquires += 1
        record("stream.lock_wait", t0, t1)

    def __exit__(self, *exc) -> None:
        self.lock.release()


class _PendingAdmit:
    __slots__ = ("ids", "length", "scale", "event", "mel", "frames",
                 "active", "error", "queued")

    def __init__(self, ids: np.ndarray, length: int, scale: float):
        self.ids = ids
        self.length = length
        self.scale = scale
        # (admission number, put time in ns) while tracing is on
        self.queued: Optional[tuple] = None
        self.event = threading.Event()
        self.mel: Optional[torch.Tensor] = None
        self.frames = 0
        self.active: Optional[_Active] = None  # None: the short path
        self.error: Optional[BaseException] = None


class StreamBatcher:
    """Share batched calls across concurrent streams.

    ``streamer``: the shared ``StreamingSynthesizer``. ``lock``: the device
    lock shared with the server's other routes. ``max_streams``: the
    batch cap of a chunk call (batches pad up to a bucket of
    ``(1, 2, 4, 8, 16)`` capped at it). ``max_wait_ms``: the admission
    window the first queued request opens.
    """

    def __init__(self, streamer, lock: Optional[threading.Lock] = None,
                 max_streams: int = 8, max_wait_ms: float = 5.0):
        self.streamer = streamer
        self.lock = lock if lock is not None else threading.Lock()
        self.max_streams = int(max_streams)
        self.max_wait = float(max_wait_ms) / 1000.0
        sv = streamer.vocoder
        self._sv = sv
        self._U = sv.upsample
        self._W = sv._window
        self._chunk = sv.chunk_frames
        self._closed = False
        self._submit_mu = threading.Lock()
        self._admit_q: "queue.SimpleQueue[Optional[_PendingAdmit]]" = (
            queue.SimpleQueue())
        self._mu = threading.Lock()          # guards _active and _idle
        self._active: deque = deque()
        self._wake = threading.Event()       # scheduler: work arrived
        self._idle = threading.Event()       # close(): scheduler drained
        self._idle.set()
        # streams_served counts admitted utterance chunks (a long text
        # admits one per sentence chunk)
        self.streams_served = 0
        self.chunk_dispatches = 0
        self.chunks_emitted = 0
        self.admit_passes = 0
        self.admitted = 0
        self.lock_acquires = 0
        self.lock_wait_ns = 0
        self._device = _DeviceLock(self)
        self._queued = 0  # admissions numbered while tracing is on
        self._admitter = threading.Thread(target=self._admit_loop,
                                          daemon=True, name="stream-admit")
        self._scheduler = threading.Thread(target=self._schedule_loop,
                                           daemon=True, name="stream-sched")
        self._admitter.start()
        self._scheduler.start()

    # -- client side ----------------------------------------------------------
    def stream(self, text: str, duration_scale: float = 1.0,
               timeout: Optional[float] = None, gap_ms: float = 120.0
               ) -> Iterator[np.ndarray]:
        """Admit ``text`` (blocks until its acoustic pass ran, coalesced
        with concurrent arrivals) and return its chunk iterator; safe from
        many threads. ``timeout`` bounds each wait. A long text is split by
        sentence and every sentence is admitted at once; the iterator
        yields them in order with ``gap_ms`` of silence between."""
        st = self.streamer
        pendings = []
        for chunk in st.split_long(text):
            enc = st.text_processor.batch([chunk], st.text_bucket)
            pendings.append(_PendingAdmit(np.asarray(enc["phoneme_ids"][0]),
                                          int(enc["lengths"][0]),
                                          float(duration_scale)))
        with self._submit_mu:
            if self._closed:
                raise RuntimeError("stream batcher is closed")
            for p in pendings:
                if tracing():
                    self._queued += 1
                    p.queued = (self._queued, time.perf_counter_ns())
                self._admit_q.put(p)
        for p in pendings:
            if not p.event.wait(timeout):
                raise TimeoutError(
                    f"acoustic pass not ready within {timeout}s")
            if p.error is not None:
                raise p.error
        return self._consume_all(pendings, timeout, gap_ms)

    def _consume_all(self, pendings: List[_PendingAdmit],
                     timeout: Optional[float], gap_ms: float
                     ) -> Iterator[np.ndarray]:
        for i, p in enumerate(pendings):
            if i:
                yield self.streamer.gap(gap_ms)
            if p.active is None:
                yield from self._stream_short(p.mel, p.frames)
            else:
                yield from self._consume(p.active, timeout)

    def _stream_short(self, mel: torch.Tensor, frames: int
                      ) -> Iterator[np.ndarray]:
        # an utterance within one window: the solo path's whole-mel f32
        # call (batching padded mels would change the edge values)
        with self._device, span("stream.short"):
            chunks = list(self._sv.stream(mel, frames))
        with self._mu:  # consumer threads race on the counter
            self.streams_served += 1
        yield from chunks

    def _consume(self, s: _Active, timeout: Optional[float]
                 ) -> Iterator[np.ndarray]:
        while True:
            try:
                kind, payload = s.out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"chunk not ready within {timeout}s")
            if kind == "chunk":
                yield payload
            elif kind == "done":
                with self._mu:
                    self.streams_served += 1
                return
            else:
                raise payload

    def reachable_buckets(self) -> List[int]:
        """Every batch a call can take, the cap included when it is not a
        bucket itself (cap 6: 1, 2, 4, 6)."""
        return sorted({_bucket(k, self.max_streams)
                       for k in range(1, self.max_streams + 1)})

    def warmup(self) -> int:
        """Run the acoustic pass and the chunk function once at every
        reachable batch (builds the kernels; on CUDA captures both graphs
        of every batch); returns the number of calls made."""
        st, sv = self.streamer, self._sv
        C = sv.model.mel_channels
        n = 0
        with self._device, torch.inference_mode():
            for b in self.reachable_buckets():
                ids = torch.zeros((b, st.text_bucket), dtype=torch.int32,
                                  device=st.device)
                lengths = torch.ones((b,), dtype=torch.int32,
                                     device=st.device)
                st._acoustic(ids, lengths, 1.0)
                sv._run_chunk(torch.zeros((b, self._W, C),
                                          device=st.device))
                n += 2
            if st.device.type == "cuda":
                torch.cuda.synchronize(st.device)
        return n

    def close(self) -> None:
        """Stop both workers. Admissions enqueued before the close still
        resolve and admitted streams drain to their end (the scheduler does
        not exit while the admitter is alive)."""
        with self._submit_mu:
            if self._closed:
                return
            self._closed = True
            self._admit_q.put(None)
        # every admission ends (its device call returns or raises), and all
        # admitted streams must be active before the drain wait means much
        self._admitter.join()
        self._idle.wait(timeout=600)
        self._wake.set()
        self._scheduler.join(timeout=60)

    # -- admission worker -----------------------------------------------------
    def _admit_loop(self) -> None:
        with torch.inference_mode():
            while True:
                first = self._admit_q.get()
                if first is None:
                    return
                batch = [first]
                deadline = time.monotonic() + self.max_wait
                stop = False
                with span("stream.admit_window"):
                    while len(batch) < self.max_streams:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            item = self._admit_q.get(timeout=remaining)
                        except queue.Empty:
                            break
                        if item is None:
                            stop = True
                            break
                        batch.append(item)
                self._admit_batch(batch)
                if stop:
                    return

    def _admit_batch(self, batch: List[_PendingAdmit]) -> None:
        by_scale: Dict[float, List[_PendingAdmit]] = {}
        for p in batch:
            by_scale.setdefault(p.scale, []).append(p)
        st = self.streamer
        for scale, group in by_scale.items():
            try:
                B = _bucket(len(group), self.max_streams)
                # pad rows repeat the last real row: discarded below, and
                # as well-behaved as real inputs (zeros need not be)
                ids = np.stack([p.ids for p in group]
                               + [group[-1].ids] * (B - len(group)))
                lengths = np.array([p.length for p in group]
                                   + [group[-1].length] * (B - len(group)),
                                   np.int32)
                with self._device:
                    self.admit_passes += 1
                    self.admitted += len(group)
                    n = self.admit_passes
                    if tracing():
                        now = time.perf_counter_ns()
                        for p in group:
                            if p.queued is not None:
                                record("stream.queued", p.queued[1], now,
                                       p.queued[0], n)
                    with span("stream.admit_pass", n):
                        mel, total = st._acoustic(
                            torch.from_numpy(ids).to(st.device),
                            torch.from_numpy(lengths).to(st.device), scale)
                        total = total.cpu().numpy()  # the one blocking fetch
                for i, p in enumerate(group):
                    p.frames = int(min(int(total[i]), st.max_frames))
                    p.mel = mel[i]
                    if p.frames > self._W:
                        p.active = _Active(p.mel, p.frames,
                                           -(-p.frames // self._chunk))
                        with self._mu:
                            self._active.append(p.active)
                            self._idle.clear()
                        self._wake.set()
            except Exception as e:
                logger.exception("batched acoustic pass failed "
                                 "(%d streams)", len(group))
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()

    # -- chunk scheduler ------------------------------------------------------
    def _schedule_loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._mu:
                    group = [self._active[i]
                             for i in range(min(len(self._active),
                                                self.max_streams))]
                    self._active.rotate(-len(group))  # round-robin
                    if not group:
                        self._idle.set()
                if not group:
                    # exit only when no admission can still activate one
                    if self._closed and not self._admitter.is_alive():
                        return
                    with span("stream.sched_wait"):
                        self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                done = self._dispatch(group)
                if done:
                    with self._mu:
                        for s in done:
                            try:
                                self._active.remove(s)
                            except ValueError:
                                pass

    def _dispatch(self, group: List[_Active]) -> List[_Active]:
        """One batched chunk call for ``group``; returns the streams that
        ended (or failed)."""
        done: List[_Active] = []
        # the dispatch's ident: the dispatches made before it
        k = self.chunk_dispatches
        try:
            with span("stream.dispatch", k):
                n = len(group)
                B = _bucket(n, self.max_streams)
                # the window math of StreamingVocoder.stream; pad slots
                # repeat the last window
                starts = [self._sv._window_start(s.ci, s.frames)
                          for s in group]
                windows = [s.mel[w: w + self._W]
                           for s, w in zip(group, starts)]
                windows += [windows[-1]] * (B - n)
                with self._device, span("stream.chunk_run", k, k):
                    # torch.stack writes a new contiguous [B, W, C] tensor,
                    # as the kernel wrapper requires
                    audio = self._sv._run_chunk(
                        torch.stack(windows).contiguous()).cpu().numpy()
                self.chunk_dispatches += 1
                with span("stream.hand_out", k, k):
                    for i, (s, w) in enumerate(zip(group, starts)):
                        start = s.ci * self._chunk
                        end = min(start + self._chunk, s.frames)
                        off = (start - w) * self._U
                        s.out.put(("chunk", audio[i, off: off + (end - start)
                                                  * self._U]))
                        self.chunks_emitted += 1
                        s.ci += 1
                        if s.ci >= s.n_chunks:
                            s.out.put(("done", None))
                            done.append(s)
        except Exception as e:
            logger.exception("batched chunk dispatch failed (%d streams)",
                             len(group))
            for s in group:
                s.out.put(("error", e))
            done = list(group)
        return done
