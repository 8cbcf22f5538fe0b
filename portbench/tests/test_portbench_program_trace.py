"""``program_trace`` runs a cell with the program's tracer on over the
window: each of the cell's readings is finite, the window names the
device's idle gaps by the program's spans, and nothing is read where
nothing was recorded; a plain run (``run_cell``) records no program span.
On the CPU at a tiny size, as ``test_portbench_check.py`` runs the cells."""

import json
import math

import pytest

from portbench import program_trace
from portbench.harness import find_cell, load_json, manifest
from portbench.run import Context, run_cell
from portbench.tests.test_portbench_check import SEED, _mix

MAN = manifest()
READ = {"flagship.bulk": ("encode_ms.bulk", "probe_ms.bulk",
                          "fetch_ms.bulk", "unpack_ms.bulk",
                          "frame_fill.bulk"),
        "flagship.stream": ("admit_queue_p95_ms.stream",
                            "admit_pass_ms.stream", "admit_batch.stream",
                            "dispatch_ms.stream", "lock_wait_ms.stream")}


def _ctx(tiny, name, trace):
    cell = find_cell(MAN, name)
    limits = dict(load_json("limits", name), min_compared=8)
    return Context(cell, SEED, 2.0, trace, device="cpu", config=tiny,
                   mix=_mix(cell), limits=limits)


@pytest.mark.parametrize("name", sorted(READ))
def test_each_reading_is_finite_in_a_traced_run(tiny, name):
    result = program_trace.run_traced(MAN, _ctx(tiny, name, True))
    assert list(result)[-1] == "checks" and result["correct"] is True
    json.dumps(result)  # the result line prints
    prog = result["program"]
    assert set(prog["metrics"]) == set(READ[name])
    assert all(math.isfinite(m["value"]) for m in prog["metrics"].values())
    labels = {lab for lab, _ in result["breakdown"]["idle_gaps"]}
    assert not labels & set(program_trace.OVERLAPPING)
    if name == "flagship.bulk":
        cc = prog["cross_check"]
        assert cc["calls"][0] == cc["calls"][1] > 0
        assert 0 < cc["launch_children"] <= 1
        assert 0 < cc["collect_children"] <= 1
    else:
        assert prog["stall"]["active_dispatch_gaps"]["n"] > 0


def test_nothing_recorded_reads_nothing():
    assert program_trace.readings([], {}) == {}
    assert program_trace.counters_of(object()) == {}


def test_a_plain_run_records_no_program_span(tiny):
    from m2tts_tpu_torch.utils import profiling

    profiling.drain()
    result = run_cell(MAN, _ctx(tiny, "flagship.bulk", False))
    assert profiling.drain() == [] and "program" not in result
    assert not profiling.tracing()


def test_marks_found_by_their_host_stamps():
    """The clock marks' pinned copies are told from a bulk call's by their
    host stamps: a burst of copies microseconds apart at the stamps, not
    the first or last copies of the run."""
    stamps = [1_000_000_000 + 20_000 * i for i in range(5)]
    marks = [(s + 150_000, s + 152_000) for s in stamps]  # the device lags
    calls = [(t, t + 900_000) for t in
             (1_000_050_000, 1_001_000_000, 1_002_000_000)]
    pinned = sorted(marks + calls + [(990_000_000, 990_900_000)])
    assert program_trace._marked_copies(pinned, stamps) == marks
    assert program_trace._marked_copies(calls, stamps) is None
