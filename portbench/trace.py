"""The measured window, and what a traced window's profiler saw.

``Window`` times the window on the host clock. With tracing on it also
runs ``torch.profiler`` (CPU and CUDA activities) over exactly that
window; afterwards ``kernels`` holds every device operation (kernels,
copies, sets; no user annotations) as (name, start ns, end ns), and
``spans`` the benchmark's own host spans (``record_function`` ranges
named ``portbench.<what>``) on the same clock.

``span(name)`` marks a stretch of host work the benchmark drives, so the
idle gaps of the device can be named by what the host was doing; the
profiler sees only the thread that opened it, so work on the program's
own threads is timed on the host clock and handed over by ``add_spans``.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

SPAN_PREFIX = "portbench."
#: the port's hand-written vocoder kernels (bf16 and 3×TF32)
VOCODER_RE = re.compile(r"\btc(32)?_stage_kernel")


def union_ns(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(name: str, on: bool) -> Iterator[None]:
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Window:
    def __init__(self, device, trace: bool):
        self.device, self.trace = device, trace
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.kernels: List[Tuple[str, int, int]] = []
        self.spans: List[Tuple[str, int, int]] = []
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Window":
        _sync(self.device)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            with torch.profiler.record_function(SPAN_PREFIX + "window"):
                pass
        self.t0 = time.perf_counter()
        return self

    def close(self) -> None:
        """End the window (after the last of its work has come back)."""
        if self.t1:
            return
        _sync(self.device)
        self.t1 = time.perf_counter()
        if self.prof is not None:
            with torch.profiler.record_function(SPAN_PREFIX + "window"):
                pass
            self.prof.__exit__(None, None, None)
            self._read()

    def __exit__(self, *exc) -> None:
        self.close()

    def add_spans(self, name: str, spans) -> None:
        """Host spans ``(start, end)`` in ``time.perf_counter`` seconds,
        put on the profiler's clock by the window's start mark."""
        off = self.start_ns - self.t0 * 1e9
        self.spans.extend((name, int(a * 1e9 + off), int(b * 1e9 + off))
                          for a, b in spans)

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def _read(self) -> None:
        from torch.autograd import DeviceType

        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.kernels.append((name, e.start_ns(), e.end_ns()))
            elif name.startswith(SPAN_PREFIX):
                self.spans.append((name[len(SPAN_PREFIX):], e.start_ns(),
                                   e.end_ns()))
        marks = sorted(s for n, s, _ in self.spans if n == "window")
        self.start_ns, self.end_ns = (marks[0], marks[-1]) if marks else (
            0, int(self.wall_s * 1e9))
        self.spans = [s for s in self.spans if s[0] != "window"]

    # -- readings of a traced window -----------------------------------------
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return union_ns((s, e) for _, s, e in self.kernels) / 1e9

    def device_s(self, pattern: Optional[re.Pattern] = None) -> float:
        """Summed device time of the operations whose name matches."""
        return sum(e - s for n, s, e in self.kernels
                   if pattern is None or pattern.search(n)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(int)
        for name, s, e in self.kernels:
            by[name[:120]] += e - s
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time in the window, summed by what the host
        was doing at each gap's middle (the innermost benchmark span, or
        ``other``), largest first."""
        gaps, reach = [], self.start_ns
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        if self.end_ns > reach:
            gaps.append((reach, self.end_ns))
        if not gaps:
            return []
        g = np.array(gaps, dtype=np.int64)
        mid, length = (g[:, 0] + g[:, 1]) // 2, g[:, 1] - g[:, 0]
        # the innermost span holding each middle: spans of one name do not
        # overlap (one thread drives them), so a search per name finds it
        best = np.full(len(g), np.iinfo(np.int64).max)
        label = np.full(len(g), "other", dtype=object)
        for name in {nm for nm, _, _ in self.spans}:
            sp = np.array(sorted((a, b) for nm, a, b in self.spans
                                 if nm == name), dtype=np.int64)
            i = np.searchsorted(sp[:, 0], mid, side="right") - 1
            ok = (i >= 0) & (sp[np.maximum(i, 0), 1] >= mid)
            width = sp[np.maximum(i, 0), 1] - sp[np.maximum(i, 0), 0]
            inner = ok & (width < best)
            best[inner], label[inner] = width[inner], name
        by = defaultdict(int)
        for lab, ln in zip(label, length):
            by[lab] += int(ln)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def record(self) -> Dict:
        return {"window_s": self.wall_s, "busy_s": self.busy_s(),
                "vocoder_device_s": self.device_s(VOCODER_RE)}
