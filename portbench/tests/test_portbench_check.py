"""The check decides ``correct``: the control (the reference one precision
down in the program's place) fails the cell's limits, and a run whose
timed path is broken underneath comes out not correct. On the CPU at a tiny
size; the harness's look for a card is skipped by building the context
directly."""

import numpy as np
import pytest
import torch

from portbench import compare, readings
from portbench.harness import find_cell, load_json, manifest
from portbench.run import Context, run_cell

MAN = manifest()
SEED = 2 ** 35 + 11


def _mix(cell):
    mix = load_json("traffic", cell["traffic"])
    if mix["driver"] == "bulk":
        return dict(mix, pool=64, sample=63)
    # enough arrivals a 10 ms admission window for batches of several rows
    return dict(mix, rate_per_s=60.0, sample=40)


@pytest.mark.parametrize("name", ["flagship.bulk", "flagship.stream"])
def test_control_fails_the_limits(tiny, name):
    cell = find_cell(MAN, name)
    limits = load_json("limits", name)
    nums = readings.control_numbers(name, SEED, "fp8", device="cpu",
                                    man=dict(MAN, run_seconds=2),
                                    config=tiny, mix=_mix(cell))
    assert nums["compared"] >= 8
    # the run's own verdict on the control's numbers, as a run reaches it
    correct, checks = compare.checks(nums, dict(limits, min_compared=8))
    assert correct is False, checks
    assert all(nums[k] > limits[k] for k in ("err_typical", "err_worst")
               if k in limits)


def _half_batch_bulk(synth):
    """Half of each call left out: its rows get the first half's answers."""
    real = synth._run

    def run(packed, scale, max_frames, want_mel, pcm_format):
        out = real(packed, scale, max_frames, want_mel, pcm_format)
        h = (out["pcm"].shape[0] + 1) // 2
        for k in ("pcm", "total_frames"):
            out[k] = torch.cat([out[k][:h], out[k][:out[k].shape[0] - h]])
        return out
    synth._run = run


def _altered_bulk(synth):
    """One answer altered where it is produced: row 0's PCM negated."""
    real = synth._run

    def run(*a):
        out = real(*a)
        out["pcm"] = out["pcm"].clone()
        out["pcm"][0] = -out["pcm"][0]
        return out
    synth._run = run


def _half_batch_stream(sb):
    """Half of each admission batch left out: its rows get the first
    half's mel and frames."""
    st = sb.streamer
    real = st._acoustic

    def acoustic(ids, lengths, scale):
        mel, total = real(ids, lengths, scale)
        h = (mel.shape[0] + 1) // 2
        keep = torch.arange(mel.shape[0]) % h
        return mel[keep], total[keep]
    st._acoustic = acoustic


def _altered_stream(sb):
    """The answers altered where they are produced: every chunk call's
    audio negated."""
    sv = sb.streamer.vocoder
    real = sv._run_chunk

    def run_chunk(mel):
        return -real(mel)
    sv._run_chunk = run_chunk


@pytest.mark.parametrize("name,fault", [
    ("flagship.bulk", None), ("flagship.bulk", _half_batch_bulk),
    ("flagship.bulk", _altered_bulk), ("flagship.stream", None),
    ("flagship.stream", _half_batch_stream),
    ("flagship.stream", _altered_stream)],
    ids=["bulk-sound", "bulk-half-batch", "bulk-altered", "stream-sound",
         "stream-half-batch", "stream-altered"])
def test_broken_timed_path_is_not_correct(tiny, name, fault):
    cell = find_cell(MAN, name)
    # the cell's limits; a tiny run serves fewer requests than a dozen
    # seconds on the card, so fewer are compared
    limits = dict(load_json("limits", name), min_compared=8)
    ctx = Context(cell, SEED, 2.0, False, device="cpu", config=tiny,
                  mix=_mix(cell), inject=fault, limits=limits)
    result = run_cell(MAN, ctx)
    assert result["checks"]["compared"]["value"] >= 8
    assert result["correct"] is (fault is None), result["checks"]
    assert np.isfinite(list(result["metrics"].values())[0]["value"])


@pytest.mark.parametrize("name", ["flagship.bulk", "flagship.stream"])
def test_serving_cells_check_the_same_numbers(name):
    """``compare.checks`` takes the numbers a limits file names: the
    serving cells' checks give ``err_typical``, ``err_worst`` and
    ``compared``, in that order, beside their limits."""
    limits = load_json("limits", name)
    nums = {"err_typical": 0.01, "err_worst": 0.02, "compared": 50}
    ok, checks = compare.checks(nums, limits)
    assert ok and list(checks) == ["err_typical", "err_worst", "compared"]
    assert [c["limit"] for c in checks.values()] == [
        limits["err_typical"], limits["err_worst"], limits["min_compared"]]
    assert not compare.checks(dict(nums, err_worst=1.0), limits)[0]
    assert not compare.checks(dict(nums, compared=39), limits)[0]
