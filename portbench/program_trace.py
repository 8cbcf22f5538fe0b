"""Run one cell with the program's own spans and counters on over the
measured window, and read them.

    python3 -m portbench.program_trace --workload flagship.bulk \
        --seed 12345 --seconds 51 --trace 1

Takes ``portbench.run``'s arguments and runs the cell through the same
``run_cell``, with the program's tracer (``m2tts_tpu_torch.utils.profiling``:
``enable``, ``drain``) on from the window's start to its close, and its
work counters (the ``Synthesizer``'s and the ``StreamBatcher``'s plain
integers) read as deltas over the window. The result line is
``portbench.run``'s plus ``program``:

- ``metrics``: the readings of ``READINGS`` that found something to read
  (per-step host ms, the frame fill, the admission's queue, pass and
  batch, the dispatch, the wait for the device lock);
- ``end_to_end`` (the driver's, also under ``--trace 1``), ``counters``,
  ``spans`` (each name's count, total, mean, p95 and largest), ``gc``
  (the collector's passes in the window), ``rusage`` (the process's CPU
  seconds), ``slowest`` (the longest spans, when and on whose thread);
- bulk: ``cross_check``, the spans against the benchmark's own
  ``launch``/``collect`` wrappers and the children's share of their
  parents; stream: ``stall``, the longest lock waits and queued
  admissions, captures inside the window and the gaps between chunk
  dispatches while streams were active.

With ``--trace 1`` also ``clock`` and ``idle_during``. The profiler's
clock is calibrated against ``time.perf_counter_ns`` by marks at both
ends of the window, and every host span (the program's and the
driver's own ``add_spans``) is put on it that way: ``Window``'s own
mapping, by one mark taken before its start time, lands them early by a
tenth of a millisecond or more. ``clock`` checks that each
``synth.fetch`` and ``stream.chunk_run`` holds its device-to-host copy
(under both mappings) and gives the device clock's offset from the
host's at both ends, by synchronous copies to pinned memory.
``idle_during`` is the device's idle time inside each span name's spans;
the window's ``idle_gaps`` name each gap by the innermost span at its
middle, with every program span name but the two whose spans overlap one
another (``stream.queued``, ``stream.lock_wait``). With ``--trace 0`` the
profiler stays off and only the tracer runs, so the end-to-end metric
against ``portbench.run --trace 0`` on the same seed is the tracer's cost.

The drivers (``drivers/bulk.py``, ``drivers/stream.py``) do not turn the
tracer on, so ``portbench.run`` reports none of these readings; this entry
point wraps the driver's ``Window`` and ``run`` for one call and leaves
them as they were.
"""

from __future__ import annotations

import argparse
import bisect
import functools
import gc
import importlib
import resource
import sys
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import numpy as np

from portbench import readers
from portbench.harness import (emit, find_cell, forbidden_modules, manifest,
                               process_start, say, use_checkout_caches)
from portbench.run import Context, run_cell
from portbench.trace import SPAN_PREFIX, Window

#: span names whose spans overlap one another (waits of several threads):
#: never handed to the window, whose gap naming assumes they do not
OVERLAPPING = ("stream.queued", "stream.lock_wait")
#: the work counters by owner's class name
COUNTERS = {
    "Synthesizer": ("calls", "frames_run", "frames_served", "truncated"),
    "StreamBatcher": ("admit_passes", "admitted", "lock_acquires",
                      "lock_wait_ns", "chunk_dispatches", "chunks_emitted",
                      "streams_served"),
}
#: each span name and the device-to-host copy it must hold
CLOCK_CHECKED = ("synth.fetch", "stream.chunk_run")


def _durations_ms(spans, name: str) -> List[float]:
    return [(s[5] - s[4]) / 1e6 for s in spans if s[0] == name]


def _mean_ms(spans, name: str) -> Optional[float]:
    d = _durations_ms(spans, name)
    return float(np.mean(d)) if d else None


def _ratio(c: Dict, num: str, den: str, scale: float = 1.0
           ) -> Optional[float]:
    if not c.get(den) or c.get(num) is None:
        return None
    return scale * c[num] / c[den]


#: each reading: (unit, function of (spans, counter deltas))
READINGS = {
    "encode_ms.bulk": ("ms", lambda s, c: _mean_ms(s, "synth.encode")),
    "probe_ms.bulk": ("ms", lambda s, c: _mean_ms(s, "synth.probe")),
    "fetch_ms.bulk": ("ms", lambda s, c: _mean_ms(s, "synth.fetch")),
    "unpack_ms.bulk": ("ms", lambda s, c: _mean_ms(s, "synth.unpack")),
    "frame_fill.bulk": ("%", lambda s, c: _ratio(c, "frames_served",
                                                 "frames_run", 100.0)),
    "admit_queue_p95_ms.stream": (
        "ms", lambda s, c: readers.p95(_durations_ms(s, "stream.queued"))),
    "admit_pass_ms.stream": ("ms",
                             lambda s, c: _mean_ms(s, "stream.admit_pass")),
    "admit_batch.stream": ("requests/pass",
                           lambda s, c: _ratio(c, "admitted",
                                               "admit_passes")),
    "dispatch_ms.stream": ("ms", lambda s, c: _mean_ms(s, "stream.dispatch")),
    "lock_wait_ms.stream": ("ms", lambda s, c: _ratio(
        c, "lock_wait_ns", "lock_acquires", 1e-6)),
}


def readings(spans, counters: Dict) -> Dict[str, Dict]:
    """The readings that find something to read, by name."""
    out = {}
    for name, (unit, fn) in READINGS.items():
        v = fn(spans, counters)
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def counters_of(program) -> Dict[str, int]:
    names = COUNTERS.get(type(program).__name__, ())
    return {k: getattr(program, k) for k in names if hasattr(program, k)}


def span_table(spans) -> Dict[str, Dict]:
    """Count, total seconds, mean, p95 and largest ms of each span name."""
    by = defaultdict(list)
    for s in spans:
        by[s[0]].append((s[5] - s[4]) / 1e6)
    return {k: {"n": len(v), "total_s": float(np.sum(v)) / 1e3,
                "mean_ms": float(np.mean(v)),
                "p95_ms": float(np.percentile(v, 95)),
                "max_ms": float(np.max(v))} for k, v in sorted(by.items())}


def children_share(spans, parent: str, children) -> Optional[float]:
    """Summed time of ``children`` over their parents' (by ident)."""
    whole = sum(s[5] - s[4] for s in spans if s[0] == parent)
    part = sum(s[5] - s[4] for s in spans if s[0] in children)
    return part / whole if whole else None


def clock_check(win: Window, spans, at) -> Dict[str, Dict]:
    """For each span name of ``CLOCK_CHECKED``: how many of its spans, put
    on the profiler's clock by ``at`` (a function of perf_counter ns),
    hold a device-to-host copy from its start to its end; of the others,
    how many have no copy within a millisecond, and by how many µs the
    copy that started last before the span's end overran its end (or led
    its start); and how long before its span's end that copy typically
    ended."""
    copies = np.array(sorted((s, e) for n, s, e in win.kernels
                             if n.startswith("Memcpy DtoH")),
                      dtype=np.int64).reshape(-1, 2)
    out = {}
    for name in CLOCK_CHECKED:
        sp = [(at(s[4]), at(s[5])) for s in spans if s[0] == name]
        if not sp:
            continue
        held, missing, over, slack = 0, 0, [], []
        for a, b in sp:
            i = np.searchsorted(copies[:, 0], a)
            j = np.searchsorted(copies[:, 0], b, side="right")
            k = j - 1  # the copy that started last before the span's end
            if k >= 0 and copies[k, 1] >= a - 1e6:
                slack.append(b - copies[k, 1])
            if (copies[i:j, 1] <= b).any():
                held += 1
            elif k < 0 or copies[k, 1] < a - 1e6:
                missing += 1
            else:
                over.append(max(copies[k, 1] - b, a - copies[k, 0]) / 1e3)
        o = np.array(over) if over else np.zeros(1)
        out[name] = {"spans": len(sp), "holding_a_copy": held,
                     "share": held / len(sp), "no_copy_near": missing,
                     "overrun_us_p50_p99_max": [
                         float(np.percentile(o, 50)),
                         float(np.percentile(o, 99)), float(o.max())],
                     "copy_end_to_span_end_us_p50":
                         float(np.median(slack)) / 1e3 if slack else None}
    return out


def _roles(program) -> Dict[int, str]:
    """Thread id → the StreamBatcher's worker it is (others are callers)."""
    return {getattr(getattr(program, "_admitter", None), "ident", 0):
            "admitter",
            getattr(getattr(program, "_scheduler", None), "ident", 0):
            "scheduler"}


def stall_report(spans, program) -> Dict:
    """What a stalled stream run would show: the longest waits for the
    device lock (and whose they were), the longest queued admissions,
    captures inside the window, and the gaps between chunk dispatches
    while streams were active (no ``stream.sched_wait`` between)."""
    roles = _roles(program)
    t0 = min((s[4] for s in spans), default=0)
    waits = sorted((s for s in spans if s[0] == "stream.lock_wait"),
                   key=lambda s: s[4] - s[5])[:3]
    queued = sorted((s for s in spans if s[0] == "stream.queued"),
                    key=lambda s: s[4] - s[5])[:3]
    disp = sorted((s[4], s[5]) for s in spans if s[0] == "stream.dispatch")
    idle = np.array(sorted(s[4] for s in spans
                           if s[0] == "stream.sched_wait"), dtype=np.int64)
    gaps = []
    for (_, e), (s, _) in zip(disp, disp[1:]):
        if np.searchsorted(idle, e) == np.searchsorted(idle, s):
            gaps.append((s - e) / 1e6)
    captures = [s for s in spans if s[0] == "graph.capture"]
    g = np.array(gaps) if gaps else np.zeros(1)
    return {
        "longest_lock_waits_ms": [
            [(s[5] - s[4]) / 1e6, roles.get(s[3], "caller"),
             (s[4] - t0) / 1e9] for s in waits],
        "longest_queued_ms": [[(s[5] - s[4]) / 1e6, (s[4] - t0) / 1e9]
                              for s in queued],
        "captures_in_window": [[str(s[1]), (s[5] - s[4]) / 1e6]
                               for s in captures],
        "active_dispatch_gaps": {
            "n": len(gaps), "p50_ms": float(np.percentile(g, 50)),
            "p99_ms": float(np.percentile(g, 99)),
            "max_ms": float(g.max()), "total_s": float(g.sum()) / 1e3,
            "over_5ms": int((g > 5).sum())},
    }


def _intersect_ns(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return float(total)


def _merged(intervals) -> List:
    out: List = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_during(win: Window, mapped) -> Dict[str, float]:
    """Seconds of the device's idle time in the window that fall inside
    each span name's spans (on the profiler's clock); names on one thread
    exclude each other, names on other threads may overlap."""
    busy = _merged((s, e) for _, s, e in win.kernels)
    idle, reach = [], win.start_ns
    for s, e in busy:
        if s > reach:
            idle.append((reach, min(s, win.end_ns)))
        reach = max(reach, e)
    if win.end_ns > reach:
        idle.append((reach, win.end_ns))
    by = defaultdict(list)
    for name, s, e in mapped:
        by[name].append((s, e))
    out = {n: _intersect_ns(idle, _merged(v)) / 1e9 for n, v in by.items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def slowest(spans, program, n: int = 12) -> List:
    """The longest spans of the window other than the waits that are long
    by design (queued, the scheduler's and the admitter's idle), with
    their start in seconds from the window's first span and the thread's
    role."""
    roles = _roles(program)
    t0 = min((s[4] for s in spans), default=0)
    skip = ("stream.queued", "stream.sched_wait", "stream.admit_window")
    top = sorted((s for s in spans if s[0] not in skip),
                 key=lambda s: s[4] - s[5])[:n]
    return [[s[0], round((s[4] - t0) / 1e9, 4), (s[5] - s[4]) / 1e6,
             roles.get(s[3], "caller")] for s in top]


#: the farthest the device's clock may lie from the host's (ns)
MAX_CLOCK_OFFSET_NS = 5_000_000


def _marked_copies(pinned: List, stamps: List[float]) -> Optional[List]:
    """Of the pinned copies ``pinned`` ((start, end) on the device's
    clock, by start), the ``len(stamps)`` consecutive ones made at the host
    stamps ``stamps`` (on the profiler's host clock): those whose starts
    keep the steadiest distance from the stamps, within
    ``MAX_CLOCK_OFFSET_NS``. The marks' copies follow each other within
    microseconds, a burst no call's copies of megabytes repeats; None where
    no run of copies lies that near."""
    n = len(stamps)
    starts = [s for s, _ in pinned]
    first = bisect.bisect_left(starts, stamps[0] - MAX_CLOCK_OFFSET_NS)
    best, got = None, None
    for j in range(first, len(pinned) - n + 1):
        d = [starts[j + i] - stamps[i] for i in range(n)]
        if d[0] > MAX_CLOCK_OFFSET_NS:
            break
        if max(abs(x) for x in d) > MAX_CLOCK_OFFSET_NS:
            continue
        spread = max(d) - min(d)
        if best is None or spread < best:
            best, got = spread, pinned[j:j + n]
    return got


class _TracedWindow(Window):
    """The driver's window with the program's tracer on inside it, the
    collector's passes and the process's CPU time counted over it, and
    with tracing on the profiler's clock calibrated against
    ``time.perf_counter_ns`` by marks at both ends."""

    MARKS = 5

    def __init__(self, device, trace: bool, state: Dict):
        super().__init__(device, trace)
        self.state = state
        self.gc: List = []
        self._gc_start = 0
        self.marks: Dict[str, List] = {}
        self._at = None  # perf_counter ns → profiler ns, once calibrated

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
        else:
            self.gc.append((info["generation"], self._gc_start,
                            time.perf_counter_ns()))

    def _mark(self, tag: str) -> None:
        """Profiler marks ``portbench.<tag>.<i>``, each between two
        ``perf_counter_ns`` readings."""
        import torch

        got = []
        for i in range(self.MARKS):
            a = time.perf_counter_ns()
            with torch.profiler.record_function(f"{SPAN_PREFIX}{tag}.{i}"):
                pass
            got.append((a, time.perf_counter_ns()))
        self.marks[tag] = got
        if torch.device(self.device).type == "cuda":
            # synchronous copies to pinned memory: the device's clock
            # against perf_counter (a bulk call makes pinned copies too;
            # ``_device_offsets`` tells the marks' apart by their stamps)
            dev = torch.zeros(1, device=self.device)
            host = torch.empty(1, pin_memory=True)
            got = []
            for _ in range(self.MARKS):
                a = time.perf_counter_ns()
                host.copy_(dev)
                got.append((a, time.perf_counter_ns()))
            self.marks["gpu" + tag] = got

    def _offset(self, tag: str):
        """(perf_counter ns, profiler − perf_counter ns, half the width of
        the range the offset is known to lie in) at the tightest of the
        tag's marks: a mark opened at ``s`` and closed at ``e`` on the
        profiler's clock between ``a`` and ``b`` on perf_counter puts the
        offset between ``e - b`` and ``s - a``."""
        spans = {n: (s, e) for n, s, e in self.spans}
        best = None
        for i, (a, b) in enumerate(self.marks[tag]):
            s, e = spans[f"{tag}.{i}"]
            lo, hi = e - b, s - a
            if best is None or hi - lo < 2 * best[2]:
                best = (a, (lo + hi) / 2, (hi - lo) / 2)
        return best

    def __enter__(self) -> "_TracedWindow":
        from m2tts_tpu_torch.utils import profiling

        super().__enter__()
        if self.prof is not None:
            self._mark("clock0")
        self.state["counters0"] = counters_of(self.state.get("program"))
        self.state["rusage0"] = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._on_gc)
        profiling.drain()
        profiling.enable()
        return self

    def close(self) -> None:
        from m2tts_tpu_torch.utils import profiling

        if self.t1:
            return
        profiling.disable()
        closed = time.perf_counter_ns()
        gc.callbacks.remove(self._on_gc)
        ru0, ru1 = self.state["rusage0"], resource.getrusage(
            resource.RUSAGE_SELF)
        if self.prof is not None:
            self._mark("clock1")
        super().close()
        # a span still open at the close (a wait of an idle thread) ends
        # whenever its thread next runs: left out
        spans = [s for s in profiling.drain() if s[5] <= closed]
        c0 = self.state["counters0"]
        c1 = counters_of(self.state.get("program"))
        self.state["spans"] = spans
        self.state["counters"] = {k: c1[k] - c0[k] for k in c1 if k in c0}
        self.state["rusage"] = {
            k: getattr(ru1, k) - getattr(ru0, k)
            for k in ("ru_utime", "ru_stime")}
        g = np.array([(e - s) / 1e6 for _, s, e in self.gc]) \
            if self.gc else np.zeros(0)
        self.state["gc"] = {
            "passes": [sum(1 for x in self.gc if x[0] == k)
                       for k in range(3)],
            "total_ms": float(g.sum()), "max_ms": float(g.max(initial=0))}
        if self.trace:
            self._map(spans)

    def _map(self, spans) -> None:
        """The spans on the profiler's clock (the marks' offset,
        interpolated over the window), handed to the window by name, and
        the clock's checks."""
        (a0, c0, w0), (a1, c1, w1) = (self._offset("clock0"),
                                      self._offset("clock1"))
        self.spans = [x for x in self.spans
                      if not x[0].startswith(("clock0.", "clock1."))]
        rate = (c1 - c0) / (a1 - a0)
        window_off = self.start_ns - self.t0 * 1e9  # Window.add_spans's

        def at(t):
            return t + c0 + rate * (t - a0)

        self._at = at
        mapped = [(s[0], at(s[4]), at(s[5])) for s in spans]
        self.state["clock"] = {
            "calibrated": clock_check(self, spans, at),
            "window_mark": clock_check(self, spans,
                                       lambda t: t + window_off),
            "window_mark_error_us": (window_off - c0) / 1e3,
            "mark_half_width_us": [w0 / 1e3, w1 / 1e3],
            "drift_us": (c1 - c0) / 1e3,
            "device_offset_us": self._device_offsets(at),
            "dtoh_copies": dict(Counter(n for n, _, _ in self.kernels
                                        if "DtoH" in n))}
        self.state["idle_during"] = idle_during(self, mapped)
        by = defaultdict(list)
        for sp in spans:
            if sp[0] not in OVERLAPPING:
                by[sp[0]].append((sp[4] / 1e9, sp[5] / 1e9))
        for name, got in by.items():
            self.add_spans(name, got)

    def _device_offsets(self, at) -> Optional[List]:
        """How far the trace's device clock lies behind its host clock at
        each end of the window (µs, with half the width of the range), by
        the pinned copies ``_mark`` made: a copy made between ``a`` and
        ``b`` on perf_counter that ran from ``ks`` to ``ke`` on the
        device's clock puts the offset between ``at(a) - ks`` and
        ``at(b) - ke``. The marks' copies are found by their host stamps
        among every pinned copy of the run (``_marked_copies``)."""
        pinned = sorted((s, e) for n, s, e in self.kernels
                        if "DtoH" in n and "Pinned" in n)
        if "gpuclock0" not in self.marks:
            return None
        out = []
        for tag in ("gpuclock0", "gpuclock1"):
            got = _marked_copies(pinned, [at(a) for a, _ in
                                          self.marks[tag]])
            if got is None:
                return None
            lo, hi = max(((at(a) - ks, at(b) - ke) for (a, b), (ks, ke)
                          in zip(self.marks[tag], got)),
                         key=lambda r: r[0] - r[1])
            out.append([(lo + hi) / 2e3, (hi - lo) / 2e3])
        return out

    def add_spans(self, name: str, spans) -> None:
        """Host spans in ``time.perf_counter`` seconds on the profiler's
        clock by the calibrated marks (the driver's own spans too), once
        the window has closed; before, as ``Window`` maps them."""
        if self._at is None:
            super().add_spans(name, spans)
            return
        self.spans.extend((name, int(self._at(a * 1e9)),
                           int(self._at(b * 1e9))) for a, b in spans)


def run_traced(man: Dict, ctx: Context) -> Dict:
    """``run_cell`` with the program's tracer on over the window; the
    result with ``program`` added."""
    state: Dict = {}
    user = ctx._inject

    def inject(program):
        state["program"] = program
        if user is not None:
            user(program)

    ctx._inject = inject
    drv = importlib.import_module(f"portbench.drivers.{ctx.mix['driver']}")
    real_run, real_window = drv.run, drv.Window

    def run(c):
        out = real_run(c)
        state["out"] = out
        return out

    drv.run = run
    drv.Window = functools.partial(_TracedWindow, state=state)
    try:
        result = run_cell(man, ctx)
    finally:
        drv.run, drv.Window = real_run, real_window
    spans, counters = state["spans"], state["counters"]
    prog = {"metrics": readings(spans, counters),
            "end_to_end": state["out"]["metrics"],
            "counters": counters, "spans": span_table(spans)}
    rec = state["out"]["record"]
    if "synth.launch" in prog["spans"]:
        calls = prog["spans"]["synth.launch"]["n"]
        prog["cross_check"] = {
            "launch_ms": [prog["spans"]["synth.launch"]["mean_ms"],
                          readers.span_ms_per_call(rec, "launch")],
            "collect_ms": [prog["spans"].get("synth.collect", {})
                           .get("mean_ms"),
                           readers.span_ms_per_call(rec, "collect")],
            "calls": [calls, rec.get("calls")],
            "launch_children": children_share(
                spans, "synth.launch",
                ("synth.encode", "synth.probe", "synth.enqueue")),
            "collect_children": children_share(
                spans, "synth.collect", ("synth.fetch", "synth.unpack"))}
    if "stream.dispatch" in prog["spans"]:
        prog["stall"] = stall_report(spans, state.get("program"))
    prog["slowest"] = slowest(spans, state.get("program"))
    for k in ("gc", "rusage", "clock", "idle_during"):
        if k in state:
            prog[k] = state[k]
    result["program"] = prog
    result["checks"] = result.pop("checks")  # the contract's last key
    return result


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout_caches()
    man = manifest()
    cell = find_cell(man, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        say(f"no result: the cell needs {cell['chips']} CUDA device(s)")
        return 3
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  started=started)
    ctx.mark("import")
    torch.empty(1, device="cuda")
    ctx.mark("cuda_context")
    result = run_traced(man, ctx)
    found = forbidden_modules()
    if found:
        say(f"no result: the run loaded {found}")
        return 4
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
