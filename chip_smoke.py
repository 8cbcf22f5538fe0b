"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``m2tts_tpu_torch/csrc`` (and counts,
in both tensor-core kernels' SASS, their wgmma instructions and the waits
on them), holds each
against its plain PyTorch version at the flagship widths (the vocoder
kernels whole and stage by stage: ``vocoder_tc.cu`` in bf16, the 3×TF32
``vocoder_tc32.cu`` in f32; the vocoder also at the XL config's 512
channels), times them beside the cuDNN ``Vocoder`` module (and the probe by
its device time beside ``torch.add``'s), then drives
the flagship serving path (``serving.pipeline.from_config(FLAGSHIP_MODEL)``,
seeded random weights, ``vocoder_backend='auto'``) on eight texts in bf16
and f32, checks its audio against the plain packed-matmul vocoder, and
shows through the launch counters that the path ran the kernels. Then the
serving paths on the same weights and texts, each with the counters zeroed
just before it and read just after:

- ``streaming``: ``StreamingSynthesizer`` (64-frame chunks, 4-frame halo)
  in f32 (``vocoder_tc32.cu``) and bf16 (``vocoder_tc.cu``), each stream
  held against its mel vocoded whole by the kernel and against the plain
  version's stream; a 64-frame mel through the short path (the f32 kernel
  in both); first-chunk latency, per-chunk device time, real-time factor;
- ``stream_batcher``: eight concurrent streams through a ``StreamBatcher``,
  each equal to its solo stream, with fewer chunk calls than chunks;
- ``dynamic_batcher``: sixteen concurrent ``submit`` calls, fewer batches
  than requests, frames equal to ``synthesize_batch``'s;
- ``http``: the server's routes on 127.0.0.1 (``make_handler`` with the
  batchers), each payload against the direct call, ``/reload`` from a
  checkpoint written by ``CheckpointManager``.

Then stage-1 training at the flagship's full width and depth
(``Stage1Trainer`` on ``FLAGSHIP_MODEL`` + ``FLAGSHIP_TRAINING``: batch 32,
bf16, bf16 transfers, data-free ``DummyDataset`` over the three buckets;
only the loop's lengths and the schedule are overridden, ``TRAIN_OVERRIDES``):

- ``train``: 30 steps through the ``DevicePrefetcher`` and 30 with the
  device data cache, each validating, pinning ``best/`` and writing a
  checkpoint; steps/s, ms per step by bucket, peak memory, losses (fails
  on a non-finite loss or a validation loss that did not fall);
  ``train_xl``: 5 steps at ``configs/flagship_xl.yaml``'s widths;
- ``train_vs_cpu``: two f32 steps on the card against the same steps on
  the CPU (same weights and batch, dropout 0, TF32 off), held to the bars
  in ``TRAIN_VS_CPU``;
- ``train_to_serve``: ``from_checkpoint`` of the run's latest and ``best``
  checkpoints (``auto``, so ``vocoder_tc.cu``) on the eight texts, PCM
  equal at 0 LSB to a Synthesizer on the trainer's in-memory weights.

One JSON line per phase; the line before the last lists the kernels (with
the launches of every path and the paths that made them), the last is
``{"ok": true, "device": {...}}``. Any failed check raises and the exit
code is nonzero. Needs one CUDA device, ``nvcc`` and no network or PyYAML.

    python3 chip_smoke.py --profile

adds a ``main_path_profile`` line: device time by kernel name for one
batch-64 ``synthesize_batch`` (torch.profiler) and the device's busy share,
a ``stream_profile_f32`` and ``stream_profile_bf16`` line: the same for
one stream of the longest text, and a ``train_profile`` line: the same for
5 flagship train steps at the (128, 512) bucket.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the eight evaluation texts of the TPU package's bench
EVAL_TEXTS = [
    "Hello world, this is a test of the improved model.",
    "The quick brown fox jumps over the lazy dog.",
    "M2 TTS generates high quality speech synthesis.",
    "This model runs efficiently on Apple Silicon hardware.",
    "Printing, in the only sense with which we are at present concerned.",
    "The invention of movable metal letters was the immediate cause.",
    "Speech synthesis research moved to neural vocoders many years ago.",
    "A fast non autoregressive model can serve many streams at once.",
]
SEED = 0
FRAME_TARGET = 460  # ~90% of the 512-frame bucket for the longest text
SHAPES = [(1, 5), (3, 200), (64, 512)]
EDGE_SHAPES = [(1, 1), (2, 7), (5, 333)]
# the vocoder width of configs/flagship_xl.yaml, held at one shape
XL_CHANNELS = 512
XL_SHAPES = [(3, 200)]
F32_TOL = {"atol": 3e-5, "rtol": 1e-4}
# bf16 kernel against the bf16 plain version, same rounding points: the
# f32 sums run in another order, so an intermediate can round to the
# neighbouring bf16 value (2^-8 relative) and the flip propagates to the
# output; bounded at 1/10 of the bf16-against-f32 bars below
BF16_TOL = {"max_abs": 1.5e-2, "mean_abs": 2e-3}
BF16_VS_F32 = {"max_abs": 0.15, "mean_abs": 2e-2}
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type.
# The f32 kernel runs each f32 product as three TF32 products (495 TFLOP/s),
# so its operations peak is a third of that; the f32 FMA pipe's 67 TFLOP/s
# is the bound of a kernel without tensor cores.
# stage-1 training: the only changes to the flagship's training config
TRAIN_OVERRIDES = {"training.max_steps": 30, "training.log_every": 10,
                   "training.validate_every": 15,
                   "training.save_every": 1000,
                   "training.warmup_steps": 10,
                   "training.learning_rate": 1e-3}
XL_STEPS = 5
# f32 train steps on the card against the CPU (TF32 off on the card):
# relative error of each loss and of grad_norm, relative L2 error of each
# gradient tensor, max abs error of the params. Adam's first update moves a
# weight by lr·g/(|g| + 1e-8): where |g| is within a few eps of zero, a
# gradient error of 1e-10 moves it by a few % of lr, so the params are
# held to a tenth of lr (1e-3)
TRAIN_VS_CPU = {"loss_rel": 1e-5, "grad_norm_rel": 1e-5, "grad_rel_l2": 1e-5,
                "params_abs": 1e-4}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 495e12 / 3, "bf16": 989e12}
FMA_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_work(B: int, T: int, c_mel: int, channels: int, rates, i: int,
               abytes: int):
    """(FLOPs stage ``i``'s launch needs with the zero tconv taps skipped,
    bytes it must move: its input read once, its output written once, its
    weights read once). Activations between stages take ``abytes`` bytes,
    mel in and audio out 4."""
    t, c = T * math.prod(rates[:i]), channels >> i
    r, co = rates[i], c // 2
    first, last = i == 0, i == len(rates) - 1
    flops = 2 * 2 * c * co * r * t + 2 * (2 * 3 * co * co) * r * t
    wcount = 3 * c * r * co + 2 * 3 * co * co
    nbytes = B * t * (c_mel * 4 if first else c * abytes)
    nbytes += B * t * r * (4 if last else co * abytes)
    if first:
        flops += 2 * 3 * c_mel * c * t
        wcount += 3 * c_mel * c
    if last:
        flops += 2 * 3 * co * t * r
        wcount += 3 * co
    return B * flops, nbytes + wcount * abytes


def vocoder_work(B: int, T: int, c_mel: int, channels: int, rates,
                 wbytes: int):
    """(FLOPs this input needs with the zero tconv taps skipped, bytes that
    must move: mel read, audio written, weights read once)."""
    flops = sum(stage_work(B, T, c_mel, channels, rates, i, wbytes)[0]
                for i in range(len(rates)))
    wcount = 3 * c_mel * channels + 3 * (channels >> len(rates))
    c = channels
    for r in rates:
        wcount += 3 * c * r * (c // 2) + 2 * 3 * (c // 2) ** 2
        c //= 2
    return flops, (B * T * c_mel * 4 + B * T * math.prod(rates) * 4
                   + wcount * wbytes)


def bound(flops: int, nbytes: int, cd: str):
    """(least ms the card could take, what bounds it)."""
    ops_ms = flops / PEAK_FLOPS[cd] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def held(k: torch.Tensor, p: torch.Tensor, cd: str, what: str) -> float:
    """Hold kernel output k against the plain version p; the max abs error."""
    if k.shape != p.shape or not torch.isfinite(k).all():
        raise RuntimeError(f"kernel output bad at {what}: {tuple(k.shape)}")
    err = (k.float() - p.float()).abs()
    if cd == "f32":
        torch.testing.assert_close(k, p, **F32_TOL)
    elif err.max() > BF16_TOL["max_abs"] or err.mean() > BF16_TOL["mean_abs"]:
        raise RuntimeError(f"bf16 kernel vs bf16 plain at {what}: max "
                           f"{err.max().item()} mean {err.mean().item()}")
    return err.max().item()


def wgmma_sass(lib, nvcc: str) -> dict:
    """Per kernel of a built library, from ``cuobjdump -sass``: its wgmma
    instructions (HGMMA) and the waits on them (WARPGROUP.DEPBAR). A wait
    after every wgmma means ptxas serialised them."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(tc(?:32)?_stage_kernel)I((?:Li\d+E)+)E", line)
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2))) if m else ""
            fn = f"{m.group(1)}<{args}>" if m else line.split()[-1]
            counts[fn] = {"hgmma": 0, "depbar": 0}
        elif fn is not None and "HGMMA" in line:
            counts[fn]["hgmma"] += 1
        elif fn is not None and "WARPGROUP.DEPBAR" in line:
            counts[fn]["depbar"] += 1
    return counts


def device_ms(fn, iters: int) -> dict:
    """Per call of ``fn`` over ``iters`` back-to-back calls: the device time
    of its kernels (torch.profiler), the kernels a call launches, and the
    host time a call takes to issue."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in ev)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {"device_ms": total_us / iters / 1e3,
            "kernels_per_call": sum(e.count for e in ev) / iters,
            "host_issue_ms": host_s / iters * 1e3,
            "kernel_names": sorted({e.key[:60] for e in ev})}


def profile_batch(run, card: str, top: int = 12,
                  phase: str = "main_path_profile") -> dict:
    """Device time of one ``run()`` by kernel name (torch.profiler), and the
    device's busy share of the host wall time around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device kernels and copies; a record_function range (an "annotation",
    # such as the optimizer's step) spans them and would count them twice
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in events if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda k: -k[1])
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if e.device_type == DeviceType.CPU),
                  key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {"phase": phase, "card": card, "wall_us": wall_us,
            "device_busy_us": busy_us, "busy_share": busy_us / wall_us,
            "device_ops": sum(k[2] for k in kernels),
            "top": [{"name": n[:80], "us": t, "calls": c}
                    for n, t, c in kernels[:top]],
            "host_top": [{"name": n[:80], "self_us": t, "calls": c}
                         for n, t, c in host[:top]]}


def packed_eval_texts(synth):
    """(ids, lengths) of the eight texts in ``synth``'s buckets."""
    from m2tts_tpu_torch.serving.pipeline import encode_packed_batch

    packed = encode_packed_batch(synth.text_processor, EVAL_TEXTS,
                                 synth.batch_buckets, synth.text_buckets)
    return packed[:, :-1], packed[:, -1]


def calibrate_scale(synth, ids, lengths) -> float:
    """The duration scale that puts the longest text at ~FRAME_TARGET
    frames by ``synth``'s duration probe."""
    scale = 1.0
    for _ in range(8):  # frames are nonlinear in the scale: iterate
        peak = float(synth.predict_frames(ids, lengths, scale).max())
        if peak <= 0:
            scale *= 64.0
            continue
        if abs(peak - FRAME_TARGET) / FRAME_TARGET < 0.03:
            break
        scale *= FRAME_TARGET / peak
    return scale


class Counters:
    """The kernels' launch counters: zeroed just before a path is driven,
    read just after."""

    NAMES = ("fused_vocoder_tc", "fused_vocoder_tc32", "probe")

    def __init__(self, build, cuda_vocoder):
        self.build, self.cuda_vocoder = build, cuda_vocoder

    def zero(self) -> None:
        self.cuda_vocoder.LAUNCHES_TC = 0
        self.cuda_vocoder.LAUNCHES_TC32 = 0
        self.build.PROBE_LAUNCHES = 0

    def read(self) -> dict:
        return dict(zip(self.NAMES, (self.cuda_vocoder.LAUNCHES_TC,
                                     self.cuda_vocoder.LAUNCHES_TC32,
                                     self.build.PROBE_LAUNCHES)))


def run_threads(fn, n: int, timeout: float = 120.0):
    """fn(i) in n daemon threads released together by a barrier; (results,
    wall seconds). Raises the first error, or when a thread hangs."""
    import threading

    results, errors = [None] * n, []
    barrier = threading.Barrier(n)

    def worker(i):
        try:
            barrier.wait(timeout=timeout)
            results[i] = fn(i)
        except BaseException as e:  # re-raised in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a worker thread hung")
    if errors:
        raise errors[0]
    return results, wall


def pcm_diff(a: np.ndarray, b: np.ndarray, bar, what: str) -> dict:
    """Max and mean |a - b| in LSB, held against bar = (max, mean or
    None)."""
    if a.shape != b.shape:
        raise RuntimeError(f"{what}: {a.shape} samples against {b.shape}")
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    lsb, mean = int(d.max(initial=0)), float(d.mean()) if d.size else 0.0
    if lsb > bar[0] or (bar[1] is not None and mean > bar[1]):
        raise RuntimeError(f"{what}: PCM differs by {lsb} LSB (mean {mean})")
    return {"max_pcm_lsb": lsb, "mean_pcm_lsb": mean}


def streaming_phase(model, scale: float, sample_rate: int, card: str,
                    counters: Counters) -> dict:
    """StreamingSynthesizer at the flagship width in f32 (→ vocoder_tc32.cu)
    and bf16 (→ vocoder_tc.cu) over the eight texts, and one mel of 64
    frames through the short path (→ vocoder_tc32.cu in both). Each stream
    is held against its mel vocoded whole by the kernel and against the
    plain version's stream; then first-chunk latency, per-chunk device time
    and the stream's real-time factor."""
    from m2tts_tpu_torch.ops.cuda.vocoder import fused_vocoder_forward
    from m2tts_tpu_torch.ops.vocoder_mm import (pack_vocoder_weights,
                                                vocoder_mm_forward)
    from m2tts_tpu_torch.serving.streaming import (StreamingSynthesizer,
                                                   StreamingVocoder)

    rates, U = model.upsample_rates, model.total_upsample
    ss = {cd: StreamingSynthesizer(model, chunk_frames=64, max_frames=512,
                                   text_bucket=128, compute_dtype=cd,
                                   device="cuda")
          for cd in ("f32", "bf16")}
    if any(s.vocoder.vocoder_backend != "cuda" for s in ss.values()):
        raise RuntimeError("streaming 'auto' did not resolve to the kernels")
    W = ss["f32"].vocoder._window
    # every text's mel as the stream's acoustic pass makes it
    mels = {}
    with torch.inference_mode():
        for cd, s in ss.items():
            mels[cd] = []
            for text in EVAL_TEXTS:
                enc = s.text_processor.batch([text], s.text_bucket)
                mel, total = s._acoustic(
                    torch.from_numpy(enc["phoneme_ids"]).cuda(),
                    torch.from_numpy(enc["lengths"]).cuda(), scale)
                mels[cd].append(mel[0, :min(int(total[0]), s.max_frames)])
    short_mel = mels["f32"][0][:W - 8]
    if not 0 < short_mel.shape[0] <= W:
        raise RuntimeError(f"short-path mel of {short_mel.shape[0]} frames")

    counters.zero()
    streams, short, by_part = {}, {}, {}
    for cd, s in ss.items():
        c0 = counters.read()
        streams[cd] = [np.concatenate(list(s.stream(t, scale)))
                       for t in EVAL_TEXTS]
        c1 = counters.read()
        short[cd] = s.vocoder.synthesize(short_mel)
        c2 = counters.read()
        by_part[cd] = {"streams": {k: c1[k] - c0[k] for k in c0},
                       "short_path": {k: c2[k] - c1[k] for k in c0}}
        sp = by_part[cd]["short_path"]
        if sp["fused_vocoder_tc32"] != len(rates) or sp["fused_vocoder_tc"]:
            raise RuntimeError(f"{cd} short path launched {sp}, expected "
                               f"{len(rates)} f32-kernel stage launches")
    launches = counters.read()
    if launches["fused_vocoder_tc"] < 1 or launches["fused_vocoder_tc32"] < 1:
        raise RuntimeError(f"streaming skipped a kernel: {launches}")

    out = {"phase": "streaming", "card": card, "launches": launches,
           "chunk_frames": 64, "window_frames": W,
           "short_path_frames": int(short_mel.shape[0])}
    for cd, s in ss.items():
        sv = s.vocoder
        packed = {k: pack_vocoder_weights(model.vocoder, k)
                  for k in {cd, "f32"}}
        plain = StreamingVocoder(model, chunk_frames=64, compute_dtype=cd,
                                 vocoder_backend="mm", device="cuda")
        err_whole = err_plain = 0.0
        for i, (mel, streamed) in enumerate(zip(mels[cd], streams[cd])):
            if streamed.shape != (mel.shape[0] * U,):
                raise RuntimeError(f"{cd} stream {i}: {streamed.shape} "
                                   f"samples for {mel.shape[0]} frames")
            got = torch.from_numpy(streamed)
            whole = fused_vocoder_forward(mel[None].contiguous(), packed[cd],
                                          rates, cd)[0].cpu()
            err_whole = max(err_whole, held(got, whole, cd,
                                            f"{cd} stream {i} vs whole"))
            err_plain = max(err_plain, held(
                got, torch.from_numpy(plain.synthesize(mel)), cd,
                f"{cd} stream {i} vs the plain stream"))
        ref_short = vocoder_mm_forward(short_mel[None], packed["f32"],
                                       "f32")[0].cpu()
        err_short = held(torch.from_numpy(short[cd]), ref_short, "f32",
                         f"{cd} short path vs vocoder_mm_forward")
        # one chunk window [1, W, C] through the kernel and the plain
        # version, by CUDA events
        win = mels[cd][0][None, :W].contiguous()
        with torch.inference_mode():
            chunk_ms = cuda_time_ms(lambda: sv._run_chunk(win), 50)
            plain_ms = cuda_time_ms(lambda: plain._run_chunk(win), 20)
        flops, nbytes = vocoder_work(1, W, model.mel_channels,
                                     model.vocoder_channels, rates,
                                     4 if cd == "f32" else 2)
        chunk_bound, chunk_bound_by = bound(flops, nbytes, cd)
        first, rtf, per_chunk = [], [], []
        for i in range(12):  # warm: every text has streamed once above
            text = EVAL_TEXTS[i % len(EVAL_TEXTS)]
            t0 = time.perf_counter()
            it = s.stream(text, scale)
            c0 = next(it)
            t1 = time.perf_counter()
            rest = list(it)
            t2 = time.perf_counter()
            samples = len(c0) + sum(len(c) for c in rest)
            first.append((t1 - t0) * 1e3)
            rtf.append((t2 - t0) / (samples / sample_rate))
            per_chunk.append((t2 - t1) * 1e3 / len(rest))
        out[cd] = {
            "kernel": "fused_vocoder_tc32" if cd == "f32"
            else "fused_vocoder_tc",
            "launches": by_part[cd],
            "frames": [int(m.shape[0]) for m in mels[cd]],
            "chunks": [-(-int(m.shape[0]) // 64) for m in mels[cd]],
            "max_abs_err_vs_whole": err_whole,
            "max_abs_err_vs_plain": err_plain,
            "short_path_max_abs_err": err_short,
            "first_chunk_ms_median": float(np.median(first)),
            "first_chunk_ms_min": min(first), "first_chunk_ms_max": max(first),
            "host_ms_per_later_chunk_median": float(np.median(per_chunk)),
            "stream_rtf_median": float(np.median(rtf)),
            "timed_streams": len(first),
            "chunk_device_ms": chunk_ms, "chunk_plain_ms": plain_ms,
            "chunk_bound_ms": chunk_bound, "chunk_bound_by": chunk_bound_by,
            "chunk_shape": list(win.shape)}
    emit(out)
    out["streamers"], out["streams"] = ss, streams
    return out


def stream_batcher_phase(streamer, solo, scale: float, card: str,
                         counters: Counters) -> dict:
    """Eight concurrent streams (the eight texts) through one StreamBatcher
    over the bf16 streamer; each equals its solo stream."""
    from m2tts_tpu_torch.serving.stream_batcher import StreamBatcher

    sb = StreamBatcher(streamer, max_streams=8, max_wait_ms=20.0)
    try:
        warm = sb.warmup()
        counters.zero()
        got, wall = run_threads(lambda i: np.concatenate(list(sb.stream(
            EVAL_TEXTS[i], scale, timeout=120))), len(EVAL_TEXTS))
        launches = counters.read()
    finally:
        sb.close()
    err = max(held(torch.from_numpy(g), torch.from_numpy(s), "bf16",
                   f"batched stream {i} vs solo")
              for i, (g, s) in enumerate(zip(got, solo)))
    if not 0 < sb.chunk_dispatches < sb.chunks_emitted:
        raise RuntimeError(f"no batching: {sb.chunk_dispatches} chunk calls "
                           f"for {sb.chunks_emitted} chunks")
    if launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"stream batcher skipped the kernel: {launches}")
    audio_s = sum(len(g) for g in got) / streamer.sample_rate
    out = {"phase": "stream_batcher", "card": card, "streams": len(got),
           "launches": launches, "wall_s": wall,
           "chunk_dispatches": sb.chunk_dispatches,
           "chunks_emitted": sb.chunks_emitted,
           "streams_served": sb.streams_served, "warmup_calls": warm,
           "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
           "max_abs_err_vs_solo": err}
    emit(out)
    return out


def dynamic_batcher_phase(synth, scale: float, card: str, lsb_bar,
                          counters: Counters) -> dict:
    """Sixteen concurrent submits through one DynamicBatcher; frames equal
    one synthesize_batch call's, PCM within the bf16 bar."""
    from m2tts_tpu_torch.serving.batcher import DynamicBatcher

    texts = (EVAL_TEXTS * 2)[:16]
    ref = synth.synthesize_batch(texts, scale)
    b = DynamicBatcher(synth, max_wait_ms=200.0)
    try:
        counters.zero()
        got, wall = run_threads(
            lambda i: b.submit(texts[i], scale, timeout=120), len(texts))
        launches = counters.read()
    finally:
        b.close()
    if b.batches_run >= len(texts):
        raise RuntimeError(f"{b.batches_run} batches for {len(texts)} "
                           "requests: nothing coalesced")
    if launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"dynamic batcher skipped the kernel: {launches}")
    worst = {"max_pcm_lsb": 0, "mean_pcm_lsb": 0.0}
    for i, (g, r) in enumerate(zip(got, ref)):
        if g["frames"] != r["frames"]:
            raise RuntimeError(f"request {i}: {g['frames']} frames, "
                               f"synthesize_batch {r['frames']}")
        d = pcm_diff(g["audio_pcm"], r["audio_pcm"], lsb_bar,
                     f"batched request {i}")
        worst = {k: max(worst[k], d[k]) for k in worst}
    out = {"phase": "dynamic_batcher", "card": card, "requests": len(texts),
           "launches": launches, "batches_run": b.batches_run,
           "requests_served": b.requests_served, "wall_s": wall,
           "frames_equal": True, **worst,
           "max_pcm_lsb_bar": lsb_bar[0]}
    emit(out)
    return out


def _http(url: str, obj=None) -> tuple:
    """GET (obj None) or POST JSON with a timeout; (content type, body).
    Raises on any status but 200."""
    import urllib.request

    req = urllib.request.Request(
        url, data=None if obj is None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if obj is None else "POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise RuntimeError(f"{url}: HTTP {resp.status}")
        return resp.headers.get("Content-Type"), resp.read()


def _http_chunked(port: int, path: str, obj) -> tuple:
    """POST over a socket; (status line, headers, chunk payloads) with the
    HTTP/1.1 chunked framing parsed."""
    import socket

    body = json.dumps(obj).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                  "Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                  .encode() + body)
        f = s.makefile("rb")
        status = f.readline().decode().strip()
        headers = {}
        for line in iter(lambda: f.readline().decode().strip(), ""):
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        chunks = []
        while True:
            size = int(f.readline().decode().strip(), 16)
            data = f.read(size)
            if len(data) != size or f.read(2) != b"\r\n":
                raise RuntimeError(f"{path}: broken chunk framing")
            if size == 0:
                return status, headers, chunks
            chunks.append(data)


def http_phase(synth, streamer, scale: float, card: str, lsb_bar,
               buckets: dict, counters: Counters) -> dict:
    """The HTTP server (``make_handler`` with the batchers on) on
    127.0.0.1: /healthz, /synthesize in pcm16 and μ-law, /synthesize_batch,
    /synthesize_stream (chunked) and /reload from a checkpoint written by
    CheckpointManager (weights from seed 1)."""
    import base64
    import io
    import tempfile
    import threading
    import wave
    from http.server import ThreadingHTTPServer

    from m2tts_tpu_torch.models.tts_model import build_model, init_params
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.serving import server as http_server
    from m2tts_tpu_torch.utils.checkpoint import CheckpointManager
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    def pcm_of(wav: bytes) -> np.ndarray:
        with wave.open(io.BytesIO(wav)) as f:
            if f.getframerate() != synth.sample_rate:
                raise RuntimeError(f"WAV at {f.getframerate()} Hz")
            return np.frombuffer(f.readframes(f.getnframes()), "<i2")

    text, batch_texts = EVAL_TEXTS[0], EVAL_TEXTS[1:4]
    req = {"text": text, "duration_scale": scale}
    # what each route must answer, computed before the counted run
    exp16 = synth.synthesize(text, scale)["audio_pcm"]
    expmu = synth.synthesize(text, scale, pcm_format="mulaw")["audio_mulaw"]
    expbatch = synth.synthesize_batch(batch_texts, scale)
    # quantised as the streaming route quantises each chunk
    expstream = (np.clip(np.concatenate(list(streamer.stream(text, scale))),
                         -1.0, 1.0) * 32767.0).astype(np.int16)
    with tempfile.TemporaryDirectory() as ckdir:
        model1 = init_params(build_model(FLAGSHIP_MODEL),
                             torch.Generator().manual_seed(1), "cpu")
        CheckpointManager(ckdir).save(
            1, {"generator": model1.state_dict(), "step": 1},
            config={"model": FLAGSHIP_MODEL,
                    "data": {"sample_rate": synth.sample_rate,
                             "hop_length": synth.hop_length}})
        httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0),
            http_server.make_handler(synth, http_server.device_info(synth),
                                     stream_chunk_frames=64,
                                     dynamic_batch_wait_ms=10.0))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        port = httpd.server_address[1]
        url = f"http://127.0.0.1:{port}"
        try:
            counters.zero()
            t0 = time.perf_counter()
            health = json.loads(_http(url + "/healthz")[1])
            ctype16, wav16 = _http(url + "/synthesize", req)
            ctypemu, wavmu = _http(url + "/synthesize",
                                   {**req, "format": "mulaw"})
            batch = json.loads(_http(url + "/synthesize_batch",
                                     {"texts": batch_texts,
                                      "duration_scale": scale})[1])
            status, headers, chunks = _http_chunked(
                port, "/synthesize_stream", req)
            reloaded = json.loads(_http(url + "/reload",
                                        {"checkpoint": ckdir})[1])
            wav_after = _http(url + "/synthesize", req)[1]
            wall = time.perf_counter() - t0
            launches = counters.read()
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        fresh = pipeline.from_checkpoint(ckdir, device="cuda", **buckets)
        exp_after = fresh.synthesize(text, scale)["audio_pcm"]

    if health.get("status") != "ok" or health.get("device") != str(
            synth.device) or health.get("vocoder_backend") != "cuda":
        raise RuntimeError(f"/healthz answered {health}")
    if ctype16 != "audio/wav" or ctypemu != "audio/wav":
        raise RuntimeError(f"/synthesize content types {ctype16}, {ctypemu}")
    if not np.array_equal(pcm_of(wav16), exp16):
        raise RuntimeError("/synthesize PCM differs from synth.synthesize")
    if wavmu[20:22] != b"\x07\x00" or wavmu[58:] != expmu.tobytes():
        raise RuntimeError("/synthesize μ-law differs from synth.synthesize")
    for r, e in zip(batch["results"], expbatch):
        if not np.array_equal(pcm_of(base64.b64decode(r["audio_b64"])),
                              e["audio_pcm"]):
            raise RuntimeError("/synthesize_batch PCM differs from "
                               "synth.synthesize_batch")
    if status != "HTTP/1.1 200 OK" \
            or headers.get("transfer-encoding") != "chunked" \
            or chunks[0] != http_server.wav_stream_header(synth.sample_rate):
        raise RuntimeError(f"/synthesize_stream: {status} {headers}")
    stream_pcm = np.frombuffer(b"".join(chunks[1:]), "<i2")
    stream_d = pcm_diff(stream_pcm, expstream, lsb_bar,
                        "/synthesize_stream vs the solo stream")
    if reloaded.get("step") != 1:
        raise RuntimeError(f"/reload answered {reloaded}")
    after = pcm_of(wav_after)
    if np.array_equal(after, exp16) or not np.array_equal(after, exp_after):
        raise RuntimeError("/synthesize after /reload is not the fresh "
                           "Synthesizer's PCM on the new weights")
    if launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"the HTTP routes skipped the kernel: {launches}")
    out = {"phase": "http", "card": card, "launches": launches,
           "routes": ["/healthz", "/synthesize", "/synthesize (mulaw)",
                      "/synthesize_batch", "/synthesize_stream", "/reload",
                      "/synthesize (after reload)"],
           "wall_s": wall, "stream_http_chunks": len(chunks) - 1,
           "stream_vs_solo": stream_d, "healthz": health,
           "reload": reloaded["step"]}
    emit(out)
    return out


def train_config(model: dict, training: dict, out_dir: str, **extra):
    """The flagship-style config with ``TRAIN_OVERRIDES`` (and ``extra``)
    applied and every output under ``out_dir``."""
    from m2tts_tpu_torch.utils.config import Config

    cfg = Config({"model": model, **training})
    for key, value in {**TRAIN_OVERRIDES, **extra}.items():
        cfg.set(key, value)
    cfg.set("paths.output_dir", out_dir)
    cfg.set("paths.checkpoint_dir", f"{out_dir}/checkpoints")
    cfg.set("paths.log_dir", f"{out_dir}/logs")
    return cfg


def bucket_batches(trainer) -> dict:
    """One device batch of each bucket shape (leftover groups padded by
    cycling, as ``make_batches`` pads them with ``drop_last=False``)."""
    from m2tts_tpu_torch.data.dataset import make_batches

    out = {}
    for b in make_batches(trainer.dataset, trainer.batch_size,
                          trainer.buckets, seed=0, shuffle=False,
                          drop_last=False):
        key = (b["phoneme_ids"].shape[1], b["mel"].shape[1])
        out.setdefault(key, trainer._put(b))
    return out


def step_ms(trainer, batch, iters: int = 8, warmup: int = 2) -> float:
    """Host wall ms per train step, ``iters`` steps between two
    synchronisations (no host read inside, as in the training loop)."""
    for _ in range(warmup):
        trainer._train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        trainer._train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _read_metrics(log_dir: str):
    import csv

    with open(os.path.join(log_dir, "metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


def train_run(cfg, card: str) -> dict:
    """One training run of ``cfg`` on the card: validation before and
    after, the run's wall time and peak memory, the logged losses; the
    trainer, its final weights and the weights it pinned as best."""
    from m2tts_tpu_torch.data.dataset import DummyDataset
    from m2tts_tpu_torch.training.trainer import Stage1Trainer

    trainer = Stage1Trainer(cfg, device="cuda")
    if not isinstance(trainer.dataset, DummyDataset):
        raise RuntimeError(f"expected the data-free DummyDataset, got "
                           f"{type(trainer.dataset).__name__}")
    best = {}
    pin = trainer.save_best_checkpoint

    def save_best(score):  # keep the pinned weights for train_to_serve
        best.update(step=trainer.step, score=score, state={
            k: v.detach().clone() for k, v in trainer.model.state_dict().items()})
        pin(score)

    trainer.save_best_checkpoint = save_best
    val_before = trainer.validate()["total_loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    final = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    val_after = trainer.validate()["total_loss"]
    rows = _read_metrics(cfg.get("paths.log_dir"))
    losses = [float(r["total_loss"]) for r in rows if r.get("total_loss")]
    vals = [float(r["val_total_loss"]) for r in rows
            if r.get("val_total_loss")]
    if not losses or not all(map(math.isfinite,
                                 losses + vals + [val_before, val_after])):
        raise RuntimeError(f"non-finite or missing losses: {losses} {vals} "
                           f"{val_before} {val_after}")
    if not val_after < val_before:
        raise RuntimeError(f"validation loss did not fall: {val_before} -> "
                           f"{val_after}")
    steps = int(cfg.get("training.max_steps"))
    if trainer.step != steps or trainer.ckpt.latest_step() != steps:
        raise RuntimeError(f"run ended at step {trainer.step}, checkpoint "
                           f"{trainer.ckpt.latest_step()}")
    return {"trainer": trainer, "final": final, "best": best, "report": {
        "steps": steps, "wall_s": wall, "steps_per_s": steps / wall,
        "logged_steps_per_s": [float(r["steps_per_sec"]) for r in rows
                               if r.get("steps_per_sec")],
        "max_memory_allocated_gb": peak / 1e9,
        "total_loss_logged": {int(r["step"]): float(r["total_loss"])
                              for r in rows if r.get("total_loss")},
        "val_total_loss_before": val_before,
        "val_total_loss_after": val_after,
        "val_total_loss_in_run": vals,
        "best_step": best.get("step"),
        "checkpoints": trainer.ckpt.all_steps(),
        "sample_wavs": len(os.listdir(os.path.join(
            cfg.get("paths.output_dir"), "samples")))}}


def train_phase(out_dir: str, card: str, profile: bool = False) -> dict:
    """30 flagship steps through the DevicePrefetcher and 30 with the
    device data cache; ms per step by bucket; with ``profile`` the device
    time of 5 steps at the (128, 512) bucket; then 5 steps at the XL
    widths."""
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING,
                                              FLAGSHIP_XL_MODEL,
                                              FLAGSHIP_XL_TRAINING)

    t0 = time.perf_counter()
    runs, reports = {}, {}
    for name, cache in (("prefetcher", False), ("device_cache", True)):
        cfg = train_config(FLAGSHIP_MODEL, FLAGSHIP_TRAINING,
                           f"{out_dir}/{name}",
                           **{"training.device_data_cache": cache})
        runs[name] = train_run(cfg, card)
        reports[name] = runs[name]["report"]
    trainer = runs["prefetcher"]["trainer"]
    batches = bucket_batches(trainer)
    reports["ms_per_step_by_bucket"] = {
        f"{t},{m}": step_ms(trainer, b) for (t, m), b in batches.items()}
    tcfg = trainer.config.get("training")
    out = {"phase": "train", "card": card, "overrides": TRAIN_OVERRIDES,
           "batch_size": trainer.batch_size, "bf16": trainer.bf16,
           "transfer_dtype": str(trainer.transfer_dtype),
           "buckets": trainer.buckets, "dataset_size": len(trainer.dataset),
           "learning_rate": tcfg.get("learning_rate"), **reports,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if profile:  # before the XL run, which empties the allocator's cache
        b512 = batches[tuple(trainer.buckets[1])]
        emit(profile_batch(lambda: [trainer._train_step(b512)
                                    for _ in range(5)],
                           card, phase="train_profile"))

    # the XL stage-1 widths (its config stages the data on the device)
    cfg = train_config(FLAGSHIP_XL_MODEL, FLAGSHIP_XL_TRAINING,
                       f"{out_dir}/xl", **{"training.max_steps": XL_STEPS,
                                           "training.log_every": XL_STEPS,
                                           "training.validate_every": 1000})
    from m2tts_tpu_torch.training.trainer import Stage1Trainer

    t_xl = time.perf_counter()
    xl = Stage1Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = xl.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if xl.step != XL_STEPS or not math.isfinite(last.get("total_loss",
                                                         math.nan)):
        raise RuntimeError(f"XL run: step {xl.step}, losses {last}")
    emit({"phase": "train_xl", "card": card, "steps": XL_STEPS,
          "params": sum(p.numel() for p in xl.model.parameters()),
          "device_data_cache": xl.device_data_cache,
          "wall_s": wall, "steps_per_s": XL_STEPS / wall,
          "logged_steps_per_s": last["steps_per_sec"],
          "total_loss": last["total_loss"],
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t_xl})
    xl.close()
    del xl
    torch.cuda.empty_cache()
    out["runs"], out["batches"] = runs, batches
    return out


def train_vs_cpu_phase(out_dir: str, card: str) -> dict:
    """Two f32 steps of the flagship at the (128, 512) bucket, batch 8,
    dropout 0, constant lr, on the card and on the CPU from the same
    weights and batch, TF32 off on the card."""
    from m2tts_tpu_torch.data.dataset import make_batches
    from m2tts_tpu_torch.training.trainer import Stage1Trainer
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING)

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extra = {"model.text_encoder.dropout": 0.0, "training.bf16": False,
             "training.transfer_dtype": None, "training.batch_size": 8,
             "training.lr_scheduler": "constant",
             "training.warmup_steps": 0}
    tr = {dev: Stage1Trainer(train_config(FLAGSHIP_MODEL, FLAGSHIP_TRAINING,
                                          f"{out_dir}/vs_cpu_{dev}", **extra),
                             device=dev) for dev in ("cpu", "cuda")}
    tr["cuda"].model.load_state_dict(tr["cpu"].model.state_dict())
    frames = tr["cpu"].buckets[1][1]  # the (128, 512) bucket
    batch = next(b for b in make_batches(tr["cpu"].dataset, 8,
                                         tr["cpu"].buckets, seed=0)
                 if b["mel"].shape[1] == frames)
    steps = []
    for _ in range(2):
        (lc, gc), (lg, gg) = (tr[d]._forward_backward(tr[d]._put(batch))
                              for d in ("cpu", "cuda"))
        loss_rel = {k: abs(lg[k].item() - lc[k].item())
                    / max(abs(lc[k].item()), 1e-30) for k in lc}
        grad_rel, grad_abs = {}, 0.0
        for name, a, b in zip(tr["cpu"].param_names, gc, gg):
            d = (b.cpu() - a).norm().item()
            grad_abs = max(grad_abs, (b.cpu() - a).abs().max().item())
            grad_rel[name] = d / a.norm().item() if a.norm() > 0 else d
        tr["cpu"].optimizer.update(gc)
        tr["cuda"].optimizer.update(gg)
        params_abs = max((tr["cuda"].model.state_dict()[k].cpu() - v)
                         .abs().max().item()
                         for k, v in tr["cpu"].model.state_dict().items())
        worst = max(grad_rel, key=grad_rel.get)
        steps.append({
            "loss_rel": {k: v for k, v in loss_rel.items() if k != "grad_norm"},
            "grad_norm_rel": loss_rel["grad_norm"],
            "grad_rel_l2_max": grad_rel[worst], "grad_rel_l2_worst": worst,
            "grad_max_abs": grad_abs, "params_max_abs": params_abs,
            "total_loss": lc["total_loss"].item()})
    for st in steps:
        if (max(st["loss_rel"].values()) > TRAIN_VS_CPU["loss_rel"]
                or st["grad_norm_rel"] > TRAIN_VS_CPU["grad_norm_rel"]
                or st["grad_rel_l2_max"] > TRAIN_VS_CPU["grad_rel_l2"]
                or st["params_max_abs"] > TRAIN_VS_CPU["params_abs"]):
            raise RuntimeError(f"train step on the card vs the CPU: {st}")
    out = {"phase": "train_vs_cpu", "card": card, "bars": TRAIN_VS_CPU,
           "shape": list(batch["mel"].shape), "tf32": False,
           "steps": steps, "seconds": time.perf_counter() - t0}
    emit(out)
    for t in tr.values():
        t.close()
    return out


def train_to_serve_phase(train: dict, buckets: dict, card: str,
                         counters: Counters) -> dict:
    """The prefetcher run's latest and best checkpoints served by
    ``from_checkpoint`` (``auto``: bf16 on ``vocoder_tc.cu``) on the eight
    texts, against Synthesizers on the trainer's in-memory weights."""
    from m2tts_tpu_torch.models.tts_model import build_model
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    t0 = time.perf_counter()
    run = train["runs"]["prefetcher"]
    ckdir = run["trainer"].ckpt.directory

    def in_memory(state):
        model = build_model(FLAGSHIP_MODEL)
        model.load_state_dict(state)
        return pipeline.Synthesizer(model, vocoder_backend="auto",
                                    device="cuda", **buckets)

    served = {"latest": pipeline.from_checkpoint(ckdir, device="cuda",
                                                 vocoder_backend="auto",
                                                 **buckets),
              "best": pipeline.from_checkpoint(ckdir, step="best",
                                               device="cuda",
                                               vocoder_backend="auto",
                                               **buckets)}
    refs = {"latest": in_memory(run["final"]),
            "best": in_memory(run["best"]["state"])}
    for s in served.values():
        if (s.vocoder_backend, s.compute_dtype) != ("cuda", "bf16"):
            raise RuntimeError(f"auto resolved to {s.vocoder_backend}/"
                               f"{s.compute_dtype}")
    ids, lengths = packed_eval_texts(served["latest"])
    scale = calibrate_scale(served["latest"], ids, lengths)
    counters.zero()
    got = {k: s.synthesize_batch(EVAL_TEXTS, duration_scale=scale)
           for k, s in served.items()}
    launches = counters.read()
    if launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"train_to_serve skipped the kernel: {launches}")
    out = {"phase": "train_to_serve", "card": card, "launches": launches,
           "duration_scale": scale, "checkpoint_steps": {}}
    for k in served:
        ref = refs[k].synthesize_batch(EVAL_TEXTS, duration_scale=scale)
        for i, (a, b) in enumerate(zip(got[k], ref)):
            if a["frames"] != b["frames"] or a["frames"] <= 0 \
                    or a.get("truncated") or not np.any(a["audio_pcm"]):
                raise RuntimeError(f"{k} text {i}: frames {a['frames']} vs "
                                   f"{b['frames']}, truncated "
                                   f"{a.get('truncated')}")
            pcm_diff(a["audio_pcm"], b["audio_pcm"], (0, None),
                     f"{k} checkpoint vs in-memory weights, text {i}")
        out[k] = {"frames": [r["frames"] for r in got[k]],
                  "max_pcm_lsb": 0}
    out["checkpoint_steps"] = {"latest": served["latest"].config.get(
        "training.max_steps"), "best": run["best"]["step"]}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from m2tts_tpu_torch.ops.cuda import build, vocoder as cuda_vocoder
    from m2tts_tpu_torch.ops.vocoder_mm import (pack_vocoder_weights,
                                                vocoder_mm_forward,
                                                vocoder_mm_stage)
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    if not build.kernels_available():
        raise RuntimeError("kernels_available() is False on a CUDA device")
    sass = {name: wgmma_sass(libs[name], build._nvcc())
            for name in ("vocoder_tc", "vocoder_tc32")}
    for name, counts in sass.items():
        for fn, c in counts.items():
            if c["hgmma"] < 1 or c["depbar"] >= c["hgmma"]:
                raise RuntimeError(f"{name} {fn}: {c['hgmma']} HGMMA, "
                                   f"{c['depbar']} WARPGROUP.DEPBAR")
    emit({"phase": "build", "seconds": build_s,
          "libraries": sorted(p.name for p in libs.values()),
          "vocoder_tc_sass": sass["vocoder_tc"],
          "vocoder_tc32_sass": sass["vocoder_tc32"]})

    # ---- 3. kernels against their plain versions
    px = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    probe_err = (build.probe_add_one(px) - (px + 1.0)).abs().max().item()
    if probe_err != 0.0:
        raise RuntimeError(f"probe kernel differs from x + 1 by {probe_err}")
    # the same 200 back-to-back calls timed two ways: CUDA events (bound by
    # the host's issue rate for an 8 KB kernel) and the kernels' own device
    # time (torch.profiler)
    probe_t = {}
    for name, fn in (("probe", lambda: build.probe_add_one(px)),
                     ("plain", lambda: px + 1.0),
                     ("library", lambda: torch.add(px, 1.0))):
        probe_t[name] = {"event_ms": cuda_time_ms(fn, 200),
                         **device_ms(fn, 200)}
    emit({"phase": "probe_times", "card": card, "shape": list(px.shape),
          **probe_t})

    vcfg = FLAGSHIP_MODEL["vocoder"]
    c_mel, channels = vcfg["mel_channels"], vcfg["hidden_channels"]
    rates = tuple(vcfg["upsample_rates"])
    from m2tts_tpu_torch.models.tts_model import Vocoder, init_params

    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    nst = len(rates)
    gen = torch.Generator().manual_seed(SEED + 1)
    worst = {"f32": 0.0, "bf16": 0.0}
    # the flagship's widths at every shape, and the XL config's at one: its
    # stage 0 runs the residual convs as two column groups a block
    for config, width, shapes in (("flagship", channels, SHAPES + EDGE_SHAPES),
                                  ("flagship_xl", XL_CHANNELS, XL_SHAPES)):
        for st in (cuda_vocoder.tc_plan(rates, c_mel, width, "bf16")
                   + cuda_vocoder.tc_plan(rates, c_mel, width, "f32")):
            if cuda_vocoder.tc_smem_bytes(st) != st["smem_bytes"]:
                raise RuntimeError("the wrapper's and the kernel's shared-"
                                   f"memory layouts differ at {config} "
                                   f"{st['compute_dtype']} stage "
                                   f"r={st['r']}")
        v = init_params(Vocoder(c_mel, width, 3, rates),
                        torch.Generator().manual_seed(SEED), "cuda")
        pk = {cd: pack_vocoder_weights(v, cd) for cd in ("f32", "bf16")}
        if config == "flagship":
            voc, packed = v, pk
        for B, T in shapes:
            mel = torch.randn((B, T, c_mel), generator=gen).cuda()
            outs, stage_err = {}, {}
            for cd in ("f32", "bf16"):
                k = cuda_vocoder.fused_vocoder_forward(mel, pk[cd], rates, cd)
                torch.cuda.synchronize()
                p = vocoder_mm_forward(mel, pk[cd], cd)
                if k.shape != (B, T * math.prod(rates)):
                    raise RuntimeError(f"kernel output shape {tuple(k.shape)}")
                worst[cd] = max(worst[cd],
                                held(k, p, cd, f"{config} {(B, T)} {cd}"))
                outs[cd] = (k, p)
                # stage by stage, each launch on the plain version's input
                x, stage_err[cd] = mel, []
                for i in range(nst):
                    ks = cuda_vocoder.fused_vocoder_stage(x, pk[cd], i, cd)
                    torch.cuda.synchronize()
                    ps = vocoder_mm_stage(
                        x, pk[cd]["stages"][i], dts[cd],
                        first=pk[cd]["input_conv"] if i == 0 else None,
                        last=pk[cd]["output_conv"] if i == nst - 1 else None)
                    stage_err[cd].append(held(
                        ks, ps, cd, f"{config} {(B, T)} {cd} stage {i}"))
                    x = ps
            d = (outs["bf16"][0] - outs["f32"][1]).abs()
            if d.max() >= BF16_VS_F32["max_abs"] \
                    or d.mean() >= BF16_VS_F32["mean_abs"]:
                raise RuntimeError(f"bf16 kernel vs f32 at {config} {(B, T)}:"
                                   f" max {d.max().item()} mean "
                                   f"{d.mean().item()}")
            emit({"phase": "kernel_vs_plain", "config": config,
                  "channels": width, "shape": [B, T, c_mel],
                  "f32_max_abs_err": (outs["f32"][0] - outs["f32"][1]).abs().max().item(),
                  "bf16_max_abs_err": (outs["bf16"][0] - outs["bf16"][1]).abs().max().item(),
                  "f32_stage_max_abs_err": stage_err["f32"],
                  "bf16_stage_max_abs_err": stage_err["bf16"],
                  "bf16_vs_f32_max_abs": d.max().item(),
                  "bf16_vs_f32_mean_abs": d.mean().item(),
                  "audio_rms_f32": outs["f32"][1].pow(2).mean().sqrt().item()})
    del outs, k, p, d, x, ks, ps, v, pk

    # times at the bench shape: kernel / plain / cuDNN module per dtype,
    # and each stage launch alone
    B, T = SHAPES[-1]
    mel = torch.randn((B, T, c_mel), generator=gen).cuda()
    voc_bf16 = Vocoder(c_mel, channels, 3, rates).cuda().eval()
    voc_bf16.load_state_dict(voc.state_dict())
    voc_bf16 = voc_bf16.to(torch.bfloat16)
    times = {}
    with torch.no_grad():
        for cd in ("f32", "bf16"):
            module = voc if cd == "f32" else voc_bf16
            mel_m = mel if cd == "f32" else mel.to(torch.bfloat16)
            t = {
                "kernel": "fused_vocoder_tc" if cd == "bf16"
                else "fused_vocoder_tc32",
                "kernel_ms": cuda_time_ms(lambda: cuda_vocoder.fused_vocoder_forward(
                    mel, packed[cd], rates, cd), 10),
                "plain_ms": cuda_time_ms(
                    lambda: vocoder_mm_forward(mel, packed[cd], cd), 5),
                "module_ms": cuda_time_ms(lambda: module(mel_m), 10),
            }
            flops, nbytes = vocoder_work(B, T, c_mel, channels, rates,
                                         4 if cd == "f32" else 2)
            t["bound_ms"], t["bound_by"] = bound(flops, nbytes, cd)
            if cd == "f32":
                # what a kernel on the f32 FMA pipe could not beat
                t["fma_bound_ms"] = flops / FMA_FLOPS * 1e3
            t.update(flops=flops, bytes=nbytes,
                     tflops=flops / t["kernel_ms"] / 1e9)
            stages, x = [], mel
            for i in range(nst):
                xi = x
                ms = cuda_time_ms(lambda: cuda_vocoder.fused_vocoder_stage(
                    xi, packed[cd], i, cd), 10)
                sf, sb = stage_work(B, T, c_mel, channels, rates, i,
                                    4 if cd == "f32" else 2)
                ops_ms = sf / PEAK_FLOPS[cd] * 1e3
                bytes_ms = sb / HBM_BYTES_PER_S * 1e3
                stages.append({"stage": i, "ms": ms, "flops": sf,
                               "bytes": sb, "ops_floor_ms": ops_ms,
                               "bytes_floor_ms": bytes_ms,
                               "tflops": sf / ms / 1e9})
                if cd == "f32":
                    stages[-1]["fma_floor_ms"] = sf / FMA_FLOPS * 1e3
                # every block streams its stage's whole weight chunk stream
                # from L2 through its shared-memory ring
                st, ops = cuda_vocoder._tc_operands(
                    packed[cd], c_mel, mel.device, cd)[i]
                blocks = B * -(-xi.shape[1] // st["q_tile"])
                stages[-1].update(
                    blocks=blocks, q_tile=st["q_tile"],
                    weight_l2_bytes=blocks * ops["w"].numel()
                    * ops["w"].element_size())
                x = cuda_vocoder.fused_vocoder_stage(xi, packed[cd], i, cd)
            t["stages"] = stages
            # a per-stage design's floor: each stage at its larger floor
            t["per_stage_floor_ms"] = sum(
                max(st["ops_floor_ms"], st["bytes_floor_ms"])
                for st in stages)
            times[cd] = t
            emit({"phase": "vocoder_times", "shape": [B, T, c_mel],
                  "compute_dtype": cd, "card": card, **t,
                  "plan": cuda_vocoder.stage_plan(rates, c_mel, channels, cd)})
    del mel, voc_bf16, x

    # ---- 4. main path
    # a new process probes the kernels once when its first Synthesizer is
    # made; clear the cached answer so this run shows that launch too
    build._AVAILABLE = None
    counters = Counters(build, cuda_vocoder)
    counters.zero()
    buckets = {"text_buckets": (32, 64, 128),
               "frame_buckets": (128, 256, 384, 512),
               "batch_buckets": (1, 8, 32, 64)}
    synth = pipeline.from_config(FLAGSHIP_MODEL, seed=SEED, device="cuda",
                                 vocoder_backend="auto", **buckets)
    if synth.vocoder_backend != "cuda" or synth.compute_dtype != "bf16":
        raise RuntimeError(f"auto resolved to {synth.vocoder_backend}/"
                           f"{synth.compute_dtype}, expected cuda/bf16")
    synth_f32 = pipeline.Synthesizer(synth.model, compute_dtype="f32",
                                     vocoder_backend="auto", device="cuda",
                                     **buckets)
    ids, lengths = packed_eval_texts(synth)
    scale = calibrate_scale(synth, ids, lengths)
    results = {}
    for name, s in (("bf16", synth), ("f32", synth_f32)):
        res = s.synthesize_batch(EVAL_TEXTS, duration_scale=scale)
        for r in res:
            if r["frames"] <= 0 or r.get("truncated") \
                    or not np.isfinite(r["audio"]).all() \
                    or not np.any(r["audio_pcm"]):
                raise RuntimeError(f"bad {name} result: frames {r['frames']}"
                                   f" truncated {r.get('truncated')}")
        results[name] = res
    # throughput at batch 64 x the 512-frame bucket, bf16 (the auto path)
    texts64 = (EVAL_TEXTS * 8)[:64]
    synth.synthesize_batch(texts64, duration_scale=scale)
    torch.cuda.synchronize()
    iters, audio_s = 5, 0.0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = synth.synthesize_batch(texts64, duration_scale=scale)
        audio_s += sum(r["frames"] for r in out) * synth.upsample \
            / synth.sample_rate
    wall = time.perf_counter() - t0
    launches = counters.read()
    if min(launches.values()) < 1:
        raise RuntimeError(f"main path skipped a kernel: {launches}")
    emit({"phase": "main_path", "backend": synth.vocoder_backend,
          "duration_scale": scale,
          "frames": [r["frames"] for r in results["bf16"]],
          "launches": launches,
          "audio_s_per_s_batch64_bucket512_bf16": audio_s / wall,
          "card": card})
    if "--profile" in sys.argv[1:]:
        emit(profile_batch(lambda: synth.synthesize_batch(
            texts64, duration_scale=scale), card))

    # same texts through the plain packed-matmul vocoder in the same
    # compute dtype: f32 within 1 PCM LSB; bf16 within BF16_TOL in LSB (the
    # kernel and the plain version may round an intermediate to
    # neighbouring bf16 values), + 1 for the quantiser's rounding
    lsb_bar = {"f32": (1, None),
               "bf16": (int(BF16_TOL["max_abs"] * 32767) + 1,
                        BF16_TOL["mean_abs"] * 32767 + 1)}
    vs_mm = {}
    for cd in ("f32", "bf16"):
        synth_mm = pipeline.Synthesizer(synth.model, compute_dtype=cd,
                                        vocoder_backend="mm", device="cuda",
                                        **buckets)
        ref = synth_mm.synthesize_batch(EVAL_TEXTS, duration_scale=scale)
        lsb, total, n = 0, 0.0, 0
        for a, b in zip(results[cd], ref):
            if a["frames"] != b["frames"]:
                raise RuntimeError(f"{cd} frames differ from mm: "
                                   f"{a['frames']} vs {b['frames']}")
            d = np.abs(a["audio_pcm"].astype(np.int32) - b["audio_pcm"])
            lsb = max(lsb, int(d.max(initial=0)))
            total, n = total + float(d.sum()), n + d.size
        max_bar, mean_bar = lsb_bar[cd]
        if lsb > max_bar or (mean_bar is not None and total / n > mean_bar):
            raise RuntimeError(f"{cd} PCM differs from the mm path by {lsb} "
                               f"LSB (mean {total / n})")
        vs_mm[cd] = {"max_pcm_lsb": lsb, "mean_pcm_lsb": total / n,
                     "max_pcm_lsb_bar": max_bar}
    emit({"phase": "main_path_vs_mm", "frames_equal": True, **vs_mm})

    # ---- 5. streaming, the batchers and the HTTP server; each path with
    # the counters zeroed just before it and read just after
    streaming = streaming_phase(synth.model, scale, synth.sample_rate, card,
                                counters)
    ss16 = streaming["streamers"]["bf16"]
    if "--profile" in sys.argv[1:]:
        for cd, ss in streaming["streamers"].items():
            emit(profile_batch(lambda: list(ss.stream(EVAL_TEXTS[4], scale)),
                               card, phase=f"stream_profile_{cd}"))
    paths = {"main_path": launches, "streaming": streaming["launches"]}
    paths["stream_batcher"] = stream_batcher_phase(
        ss16, streaming["streams"]["bf16"], scale, card,
        counters)["launches"]
    paths["dynamic_batcher"] = dynamic_batcher_phase(
        synth, scale, card, lsb_bar["bf16"], counters)["launches"]
    paths["http"] = http_phase(synth, ss16, scale, card, lsb_bar["bf16"],
                               buckets, counters)["launches"]

    # ---- 6. stage-1 training at the flagship's width and depth, then its
    # checkpoints served through the kernel
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tdir:
        train = train_phase(tdir, card, "--profile" in sys.argv[1:])
        train_vs_cpu_phase(tdir, card)
        paths["train_to_serve"] = train_to_serve_phase(
            train, buckets, card, counters)["launches"]
        for run in train["runs"].values():
            run["trainer"].close()
        del train

    # ---- 7. kernels line, then the result
    def launched(name):
        return {"launches": sum(c[name] for c in paths.values()),
                "paths": [p for p, c in paths.items() if c[name]],
                "launches_by_path": {p: c[name] for p, c in paths.items()}}

    replaces = ("m2tts_tpu/ops/pallas/vocoder_packed.py:177 "
                "(fused_vocoder_packed_forward) and "
                "m2tts_tpu/ops/pallas/vocoder.py:148 (fused_vocoder_forward)")

    def vocoder_entry(cd, source, tol):
        t = times[cd]
        entry = {"name": t["kernel"], "route": "cuda", "source": source,
                 "replaces": f"{replaces}, compute_dtype={cd}",
                 **launched(t["kernel"]), "max_abs_err": worst[cd],
                 "tol": tol, "compute_dtype": cd,
                 "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
                 "module_ms": t["module_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": None,
                 "per_stage_floor_ms": t["per_stage_floor_ms"],
                 "stage_ms": [st["ms"] for st in t["stages"]],
                 "shape": [B, T, c_mel],
                 "stream_chunk_ms": streaming[cd]["chunk_device_ms"],
                 "stream_chunk_plain_ms": streaming[cd]["chunk_plain_ms"],
                 "stream_chunk_bound_ms": streaming[cd]["chunk_bound_ms"],
                 "stream_chunk_shape": streaming[cd]["chunk_shape"]}
        if "fma_bound_ms" in t:
            entry["fma_bound_ms"] = t["fma_bound_ms"]
        return entry

    # the probe's "ms" is its kernel's own device time; "event_ms" the same
    # 200 calls by CUDA events, which the host's issue rate sets
    emit({"kernels": [
        vocoder_entry("bf16", "m2tts_tpu_torch/csrc/vocoder_tc.cu",
                      {"bf16": BF16_TOL, "bf16_vs_f32": BF16_VS_F32}),
        vocoder_entry("f32", "m2tts_tpu_torch/csrc/vocoder_tc32.cu",
                      {"f32": F32_TOL}),
        {"name": "probe_add_one", "route": "cuda",
         "source": "m2tts_tpu_torch/csrc/probe.cu",
         "replaces": "m2tts_tpu/serving/pipeline.py:335 "
                     "(Synthesizer._pallas_available)",
         **launched("probe"), "max_abs_err": probe_err,
         "tol": {"max_abs": 0.0},
         "ms": probe_t["probe"]["device_ms"],
         "plain_ms": probe_t["plain"]["device_ms"],
         "module_ms": None, "bound_ms": 2 * px.numel() * 4
         / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": probe_t["library"]["device_ms"],
         "event_ms": probe_t["probe"]["event_ms"],
         "library_event_ms": probe_t["library"]["event_ms"],
         "host_issue_ms": probe_t["probe"]["host_issue_ms"],
         "library_host_issue_ms": probe_t["library"]["host_issue_ms"],
         "shape": list(px.shape)},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
