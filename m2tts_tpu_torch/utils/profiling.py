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
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Optional

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
