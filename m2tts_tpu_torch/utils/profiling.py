"""Step tracing with ``torch.profiler``.

Counterpart of ``m2tts_tpu/utils/profiling.py``: traces training steps
``[start_step, start_step + num_steps)`` and writes one chrome trace
(``trace_steps_<first>-<last>.json``, viewable in Perfetto) under
``system.profile.log_dir``:

    system:
      profile:
        start_step: 10      # first step to trace (0 = disabled)
        num_steps: 5
        log_dir: outputs/profile

Each traced step is a ``record_function`` range named ``train_step_<n>``.
Disabled (``start_step`` 0), every method is a no-op.

Spans of the serving path (a port addition; the JAX package has none):
``span(name, ident, parent)`` times a stretch of host work on
``time.perf_counter_ns()`` while tracing is on (``enable()``), and
``drain()`` hands the recorded spans over as
``(name, ident, parent, thread id, start_ns, end_ns)``. Spans of one call
or request share an ``ident``; a child names its parent's ``ident`` as its
``parent``, so a span's self time is its length less its children's. Off
(the default), ``span`` returns one shared null context after one flag
check: it allocates and records nothing. Nothing is written anywhere: the
caller that drains the spans decides what to do with them.

The spans, by module (``serving/pipeline.py``, ``serving/stream_batcher.py``,
``utils/graphs.py``):

- ``synth.launch`` (ident: the Synthesizer's call number) with the children
  ``synth.encode`` (G2P, packing, the pinned host batch), ``synth.probe``
  (the frame probe and its blocking fetch) and ``synth.enqueue`` (the
  synthesis replay, its output clones, the outputs' final forms and the
  enqueued copies to the host); ``synth.collect`` with ``synth.fetch`` (the
  wait for those copies) and ``synth.unpack`` (the trims);
- ``stream.queued`` (ident: the admission's number; parent: its pass), from
  the put on the admission queue until its pass holds the device lock;
  ``stream.admit_window`` (the coalescing window); ``stream.admit_pass``
  (ident: the pass's number; the acoustic pass and its frame-count fetch);
  ``stream.sched_wait`` (the scheduler idle, no stream active);
  ``stream.dispatch`` (ident: the dispatches before it) with
  ``stream.chunk_run`` (stack, replay, fetch) and ``stream.hand_out``
  (slices and queue puts); ``stream.short`` (a short-path call and its
  fetch); ``stream.lock_wait`` (a wait for the shared device lock);
- ``graph.capture`` (ident: the graph's key), a capture and its eager run.

``stream.queued`` and ``stream.lock_wait`` overlap others of their name
(they are waits of several threads); every other name is opened by one
thread at a time, so its spans never overlap one another.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


class StepProfiler:
    """Captures a torch.profiler trace for steps [start_step, start_step+n).

        prof = StepProfiler.from_config(config)
        for step in ...:
            with prof.step(step):
                losses = train_step(...)
        prof.close()
    """

    def __init__(self, start_step: int = 0, num_steps: int = 5,
                 log_dir: str = "outputs/profile"):
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.log_dir = str(log_dir)
        self._prof: Optional[torch.profiler.profile] = None
        self._first = 0
        self._done = self.start_step <= 0  # disabled
        self.trace_path: Optional[Path] = None

    @classmethod
    def from_config(cls, config) -> "StepProfiler":
        get = config.get if hasattr(config, "get") else lambda k, d=None: d
        return cls(
            start_step=int(get("system.profile.start_step", 0) or 0),
            num_steps=int(get("system.profile.num_steps", 5) or 5),
            log_dir=str(get("system.profile.log_dir", "outputs/profile")),
        )

    def step(self, step: int):
        """Context manager for one training step."""
        self._maybe_start(step)
        self._maybe_stop(step)
        if self._prof is not None:
            return torch.profiler.record_function(f"train_step_{step}")
        return contextlib.nullcontext()

    def _maybe_start(self, step: int) -> None:
        if self._done or self._prof is not None or step < self.start_step:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self._first = step
        logger.info("profiler: tracing steps %d..%d -> %s", step,
                    step + self.num_steps - 1, self.log_dir)

    def _maybe_stop(self, step: int) -> None:
        if self._prof is not None \
                and step >= self.start_step + self.num_steps:
            self._finish(step - 1)

    def _finish(self, last: int) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        self.trace_path = (Path(self.log_dir)
                           / f"trace_steps_{self._first}-{last}.json")
        self._prof.export_chrome_trace(str(self.trace_path))
        self._prof = None
        self._done = True
        logger.info("profiler: trace written to %s", self.trace_path)

    def close(self, last_step: Optional[int] = None) -> None:
        """Stop an in-flight trace (loop ended early)."""
        if self._prof is not None:
            self._finish(self._first + self.num_steps - 1
                         if last_step is None else last_step)


def annotate_step(name: str, step: Optional[int] = None):
    """A ``record_function`` range for an ad-hoc region: ``name``, or
    ``name#step`` for a step of a loop."""
    return torch.profiler.record_function(
        name if step is None else f"{name}#{step}")


# -- spans of the serving path ----------------------------------------------
#: one recorded span: (name, ident, parent, thread id, start_ns, end_ns)
Span = Tuple[str, object, object, int, int, int]

_TRACING = False
_SPANS: List[Span] = []  # appended from many threads (list.append is atomic)
_NULL = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "ident", "parent", "start")

    def __init__(self, name, ident, parent):
        self.name, self.ident, self.parent = name, ident, parent

    def __enter__(self) -> None:
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        _SPANS.append((self.name, self.ident, self.parent,
                       threading.get_ident(), self.start,
                       time.perf_counter_ns()))


def span(name: str, ident=None, parent=None):
    """A context manager that records ``name``'s span while tracing is on;
    off, the one shared null context."""
    if not _TRACING:
        return _NULL
    return _Open(name, ident, parent)


def record(name: str, start_ns: int, end_ns: int, ident=None,
           parent=None) -> None:
    """Record a span timed by its caller (a wait that starts on one thread
    and ends on another), on ``time.perf_counter_ns()``; nothing while
    tracing is off."""
    if _TRACING:
        _SPANS.append((name, ident, parent, threading.get_ident(), start_ns,
                       end_ns))


def tracing() -> bool:
    """Whether spans are being recorded."""
    return _TRACING


def enable() -> None:
    global _TRACING
    _TRACING = True


def disable() -> None:
    global _TRACING
    _TRACING = False


def drain() -> List[Span]:
    """The spans recorded so far, in the order they closed; the record is
    emptied."""
    out = _SPANS[:]
    del _SPANS[: len(out)]
    return out
