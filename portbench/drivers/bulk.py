"""Bulk synthesis: one client calls ``Synthesizer.synthesize_batch`` back to
back, ``batch`` texts a call in pool order (as the batch-file CLI groups a
file), and drops each call's results once counted.

End to end: ``audio_s_per_s``, all audio the calls returned in the window
over the whole window. Traced: the host time of each call before the
device (``_launch``) and after it (``_collect``, which waits for the
device), the vocoder launches' shapes, and the FLOPs of the audio
returned.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from portbench import compare
from portbench.cellkit import Cell, bucket_for, free_device, pick_sample
from portbench.harness import forbidden_modules, say
from portbench.trace import Window, span
from portbench.work import ModelFlops, launch_bound_ms

WARM_CALLS = 2


def _warm(synth, cell: Cell, calls, B: int, guard: int = 8) -> int:
    """Capture the graphs of the (batch, text, frame) shapes this traffic
    reaches, by the reference's frame counts with ``guard`` frames of room
    either way; returns how many."""
    sv = cell.serving
    shapes = set()
    for k in range(len(calls)):
        rows = slice(k * B, (k + 1) * B)
        peak = int(cell.totals[rows].max())
        b = bucket_for(len(calls[k]), sv["batch_buckets"])
        t = bucket_for(int(cell.phonemes[rows].max()), sv["text_buckets"])
        for f in {bucket_for(max(peak - guard, 0), sv["frame_buckets"]),
                  bucket_for(peak + guard, sv["frame_buckets"])}:
            shapes.add((b, t, f))
    import torch

    scale = synth._scale(1.0)
    with torch.no_grad():
        for b, t, f in sorted(shapes):
            host = np.zeros((b, t + 1), np.int32)
            host[:, -1] = 1
            packed = synth._to_device(host)
            synth._probe(packed, scale)
            synth._run(packed, scale, f, False, "int16")
    return len(shapes)


def run(ctx) -> Dict:
    mix, seed = ctx.mix, ctx.seed
    B, pool = int(mix["batch"]), int(mix["pool"])
    cell = Cell(ctx.config, mix, seed, ctx.device, pool, ctx.mark)
    calls = [cell.texts[i:i + B] for i in range(0, pool, B)]
    sample = pick_sample(cell, pool)

    synth = cell.build_synthesizer()
    ctx.mark("build_and_kernels")
    ctx.inject(synth)
    n_shapes = _warm(synth, cell, calls, B)
    ctx.mark("graph_capture")
    for k in range(WARM_CALLS):
        synth.synthesize_batch(calls[k], cell.scale)
    ctx.mark("warm_calls")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded at the end of set-up: {found}")
    graphs0 = synth.graph_stats()["graphs"]
    say(f"set-up: {n_shapes} shapes warmed, {graphs0} graphs, duration scale "
        f"{cell.scale!r}, pool mean {cell.totals.mean() * cell.hop / cell.sr:.3f}"
        f" s, {int((cell.totals > max(cell.serving['frame_buckets'])).sum())} "
        f"texts predicted past the largest frame bucket")

    trace = ctx.trace
    launches, spans = [], {"launch": 0.0, "collect": 0.0}
    launch, collect = synth._launch, synth._collect

    def seen_launch(*a, **k):
        # the (batch, frame bucket) the call ran at: the check compares
        # against the reference at the bucket the program chose
        out = launch(*a, **k)
        launches.append((int(out[0]["pcm"].shape[0]), int(out[1])))
        return out

    synth._launch = seen_launch
    if trace:
        def timed_launch(*a, **k):
            t = time.perf_counter()
            with span("launch", True):
                out = seen_launch(*a, **k)
            spans["launch"] += time.perf_counter() - t
            return out

        def timed_collect(*a, **k):
            t = time.perf_counter()
            with span("collect", True):
                out = collect(*a, **k)
            spans["collect"] += time.perf_counter() - t
            return out

        synth._launch, synth._collect = timed_launch, timed_collect

    kept: Dict[int, Dict] = {}
    served_frames = []  # (pool index, frames) of every utterance returned
    audio_samples, n_calls, k = 0, 0, 0
    ctx.setup_done()
    with Window(ctx.device, trace) as win:
        while time.perf_counter() - win.t0 < ctx.seconds:
            call_no = k % len(calls)
            with span("call", trace):
                results = synth.synthesize_batch(calls[call_no], cell.scale)
            base = call_no * B
            for i, r in enumerate(results):
                audio_samples += len(r["audio_pcm"])
                served_frames.append((base + i, int(r["frames"])))
                if base + i in sample and base + i not in kept:
                    kept[base + i] = {"pcm": r["audio_pcm"].copy(),
                                      "call": call_no, "row": i,
                                      "bucket": launches[-1][1]}
            k += 1
            n_calls += 1
        win.close()
    graphs1 = synth.graph_stats()["graphs"]
    if graphs1 != graphs0:
        say(f"WARNING: {graphs1 - graphs0} graphs captured inside the window")
    peak = ctx.memory_peak()
    audio_s = audio_samples / cell.sr
    say(f"window: {n_calls} calls, {len(served_frames)} utterances, "
        f"{audio_s:.1f} audio-s in {win.wall_s:.3f} s")

    record = {"calls": n_calls, "spans_s": spans}
    if trace:
        record.update(win.record())
        counter = ModelFlops(ctx.config["model"])
        record["model_flops"] = sum(
            counter.utterance(int(cell.phonemes[i]), f)
            for i, f in served_frames)
        s = cell.sizes
        record["vocoder_bound_s"] = sum(
            launch_bound_ms(b, f, s.mel, s.channels, s.rates,
                            synth.compute_dtype) for b, f in launches) / 1e3
    del synth
    free_device(ctx.device)

    # -- the check: the served audio of the sample against the reference ----
    pairs = []
    for idx, kp in sorted(kept.items()):
        ref_audio = cell.batch_audio(calls[kp["call"]], [kp["row"]],
                                     kp["bucket"])[0]
        pairs.append((kp["pcm"].astype(np.float32) / 32767.0, ref_audio))
    nums = compare.numbers(pairs, cell.hop, sorted(kept))
    say(f"worst compared utterance: {nums['worst']}")
    say(f"compared (frames, p50, p75, p90): {nums.pop('each')}")
    return {"attempted": len(served_frames), "failed": 0,
            "metrics": {"audio_s_per_s": audio_s / win.wall_s},
            "numbers": nums, "record": record, "window": win,
            "memory_peak_bytes": peak}
