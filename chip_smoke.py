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

- ``cuda_graphs`` (first, on the main path's weights): every path of
  this script runs as CUDA graph replays, one graph per bucket key
  (``utils/graphs.py``); this phase holds replay against
  ``disable_graphs()`` eager (``GRAPH_TOL``): batch 64 × the 512-frame
  bucket in bf16 and f32, int16 and μ-law with the mel, at two duration
  scales and two text sets, and a same-bucket ``synthesize_stream`` of
  three batches; one stream a dtype and a ``StreamBatcher`` of 4, chunk
  by chunk; ``swap_params`` against a fresh Synthesizer (and back),
  capturing no graph, and two sample validations on two weight sets, the
  second capturing none (0 LSB from a fresh validator); 8 f32 stage-1
  steps at each bucket. Figures of both ways: audio-s/s and busy
  share at 64 × 512, first chunk and ms a chunk, bf16 ms a step and busy
  share, and ``warmup(full=True)``'s capture seconds and pool memory.
  Then (the ``host_probe`` path, whose launches are the host-probe
  Synthesizer's own calls', each counted alone) the bf16 batch path with ``frame_probe='host'`` against ``'device'`` at
  batch 1 and batch 64 × the 512-frame bucket as graph replays: 0 LSB
  where both pick one bucket, no graph captured after the host path's
  warmup, each call's host time split into G2P and packing, the probe
  (the device round trip, or the CPU run), enqueueing the synthesis
  replay, the PCM fetch and ``_collect``, beside the device path's
  ``_throughput`` loop at batch 64; and the largest host − device
  frame-count gap over the eight texts at four scales, with cuDNN's TF32
  off (this run's setting) and on (a server's default);
- ``streaming``: ``StreamingSynthesizer`` (64-frame chunks, 4-frame halo)
  in f32 (``vocoder_tc32.cu``) and bf16 (``vocoder_tc.cu``), each stream
  held against its mel vocoded whole by the kernel and against the plain
  version's stream; a 64-frame mel through the short path (the f32 kernel
  in both), then three more lengths twice each, one graph a length,
  bitwise eager; first-chunk latency, per-chunk device time, real-time
  factor;
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

Then stage-2 GAN training on those checkpoints (``Stage2Trainer`` on
``FLAGSHIP_MODEL`` + ``STAGE2_TRAINING``: batch 32, bf16, 32768-sample
segments, spectral norm, envelope loss, EMA; only the loop's lengths and
the warmup are overridden, ``STAGE2_OVERRIDES``):

- ``train_stage2``: 30 steps (CUDA graph replays from a bucket's second
  step on) through the prefetcher and 30 with the device data cache, each warm-started from the ``train`` phase's stage-1
  checkpoint, validating once with the quality pass (STOI, MCD), pinning
  ``best/`` and writing a checkpoint; steps/s, ms per fused step by bucket,
  peak memory, every logged loss (fails on a non-finite one);
  ``train_stage2_xl``: 5 steps at ``configs/stage2_xl_quality.yaml``'s
  widths (device cache and both adaptive guards on), warm-started from the
  ``train_xl`` run;
- ``train_stage2_vs_cpu``: two f32 GAN steps on the card against the CPU
  (same weights and batch, dropout 0, TF32 off), held to ``STAGE2_VS_CPU``;
- ``train_stage2_to_serve``: the stage-2 run's latest and ``best``
  checkpoints (their ``generator_ema``) served through ``auto`` on the
  eight texts: PCM equal at 0 LSB to the in-memory EMA weights, within the
  bf16 bar of the ``mm`` vocoder on the same weights.

Then the phase-packed discriminator (``models/discriminator.py``'s
``packed_multiscale_apply``, ``ops/grouped_conv.py``) and the smoke suite:

- ``disc_lowering``: the flagship discriminator (16.76 M parameters) on
  [64, 8192], the stage-2 D batch; packed against the module in f32 with
  TF32 off (outputs 1e-4, gradients 1e-5, each weight-gradient lowering
  5e-4) and in bf16 (0.05); ms forward and forward+backward in bf16 for
  native and packed with each weight-gradient lowering beside the FLOP and
  byte bounds (``disc_work``), the same with cuDNN's autotuner, and the
  device operations of one forward+backward by kind;
- ``train_stage2_packed``: a few flagship GAN steps on ``FLAGSHIP_TRAINING``
  (batch 32, bf16, 8192-sample segments, no spectral norm) with
  ``disc_lowering: packed`` and with ``native``, warm-started from the
  ``train`` phase's checkpoint (the packed run must call
  ``packed_multiscale_apply`` three times in each step that runs the
  Python step: a bucket's first, eager then captured; a CUDA graph replay
  runs none); ms per fused step by bucket and a 3-step profile at
  (128, 512) for each, as graph replays and eagerly; one f32 step held
  packed against native (``PACKED_VS_NATIVE``); the packed run's
  checkpoint served through ``vocoder_tc.cu`` at 0 LSB;
- ``train_stage2_graphs``: the training graphs held against
  ``disable_graphs()`` eager (deterministic algorithms where they exist:
  bitwise, or ``GRAPH_NONDET`` with the ops that have none named): the
  recipe's fused step, packed with ``alternate_gd`` and k = 2, native on
  the device cache, validation's forward after steps and after a restore,
  stage 1 at k = 2 and its eval step; and timed both ways: ms a GAN step
  of the recipe by bucket, busy share and device operations of 3 steps,
  beside packed and native from ``train_stage2_packed``, validation's
  forward, stage 1's micro-step and eval step at k = 2;
- ``pipeline_smoke``: ``m2tts_tpu_torch.smoke.main([])`` on the card,
  7/7 parts, its vocoder launches counted.

Then the mesh paths (``multi_device``), each world of processes spawned
with ``spawn`` (they import the port and load the kernels built above):

- an NCCL world of one rank, whose (1, 1) mesh runs graphs: the flagship
  stage-1 step (f32, TF32 off) twice at each bucket and the packed GAN
  step (``FLAGSHIP_TRAINING``) twice at (128, 512), each as graph replays
  held against ``disable_graphs()`` eager under deterministic algorithms
  (``_held_pair``) and against the same work without a mesh (in a new
  process too; losses relative 1e-5, weights lr/10); the ``auto``
  Synthesizer on the mesh (eight texts, then batch 64 × the 512 bucket) in
  bf16 and f32 as graphs, against eager and ``mesh=None`` at 0 LSB; ms a
  step by bucket and ms a batch as graphs and eagerly, with and without
  the mesh, and the graphs held;
- two gloo ranks sharing the card: the (2, 1) and (1, 2) stage-1 steps
  against the single-device steps (losses rtol 2e-4 / atol 2e-5, weights
  lr/10), a (2, 1) GAN step (f32, batch 8) against one device, batch 64 ×
  512 sharded over 'data' in both dtypes (frames equal, PCM within 1 LSB)
  with each rank's kernel launches, and ``dryrun_multichip(2)``.

Then the data-backed path (``corpus_drive``): a 64-utterance v3 corpus
built by ``data.download_data`` (its seconds), its STOI floors at n = 16
held to ``artifacts/evidence_r05/corpus_floors.json`` (1e-4), the
``TTSDataset`` ingest's seconds, 300 flagship stage-1 steps (bf16, device
cache) on that ``TTSDataset`` (its validation loss must fall), 40
warm-started stage-2 steps of the recipe with one quality validation
(utt_stoi, utt_lsd), and ``evaluation.evaluate --audio-metrics`` with two
``-t`` texts on stage 2's ``best`` and earliest checkpoints (the texts run
``vocoder_tc.cu``, counted).

One JSON line per phase; the line before the last lists the kernels (with
the launches of every path and the paths that made them), the last is
``{"ok": true, "device": {...}}``. Any failed check raises and the exit
code is nonzero. Needs one CUDA device, ``nvcc``, PyYAML (the smoke
suite's config part) and no network.

    python3 chip_smoke.py --profile

adds a ``main_path_profile`` line: device time by kernel name for one
batch-64 ``synthesize_batch`` (torch.profiler) and the device's busy share,
a ``stream_profile_f32`` and ``stream_profile_bf16`` line: the same for
one stream of the longest text, a ``train_profile`` line: the same for
5 flagship train steps at the (128, 512) bucket, and a
``train_stage2_profile`` line: the same for 3 fused GAN steps there.
"""

from __future__ import annotations

import contextlib
import gc
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
# stage-2 training: the only changes to STAGE2_TRAINING's recipe (one
# validation with the quality pass and one checkpoint, at the last step)
STAGE2_OVERRIDES = {"training.max_steps": 30, "training.log_every": 10,
                    "training.validate_every": 30,
                    "training.save_every": 30,
                    "training.warmup_steps": 10}
STAGE2_XL_STEPS = 5
# two f32 GAN steps on the card against the same steps on the CPU, and
# both against the steps in f64 on the CPU. The losses and the
# discriminator (its gradient's global norm, its weights after the steps)
# take stage 1's bars: relative, and lr/10, at the recipe's lr 2e-5 (at
# stage 1's 1e-3 the first update moves the weights so far that the two
# runs' second-step losses part by 1e-4). The generator's
# gradient comes from the perceptual and envelope losses through the
# vocoder, and at these weights it is ill-conditioned in f32: near-silent
# mel bins and bands amplify the forward's rounding, so the CPU's own f32
# generator gradient lies 1e-3 (relative L2) from the f64 one, and two f32
# runs cannot agree to 1e-5. So the card's generator gradient, as a vector
# and by its global norm (which moves by at most the vector's error), must
# lie within g_vs_f64 times the CPU's vector error of the f64 gradient (+
# g_floor), and at most g_vs_f64 times as many generator weights as the
# CPU's may end more than lr/10 from the f64 steps' (Adam's first update is
# about lr·sign(g), so a weight whose gradient sign the rounding flips
# lands 2·lr away)
STAGE2_VS_CPU = {"loss_rel": 1e-5, "grad_norm_rel": 1e-5, "params_lr": 0.1,
                 "g_vs_f64": 2.0, "g_floor": 1e-7}
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


# the layout transposes; cuDNN's convolution kernels (its implicit-GEMM,
# direct and split-K reduction kernels included); the other GEMMs (cuBLAS)
_TRANSPOSE_RE = re.compile(r"nchwToNhwc|nhwcToNchw|transpose", re.I)
_CONV_RE = re.compile(r"conv|fprop|dgrad|wgrad|cudnn", re.I)
_GEMM_RE = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|sm90_", re.I)


def _union_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_batch(run, card: str, top: int = 12,
                  phase: str = "main_path_profile") -> dict:
    """Device time of one ``run()`` by kernel name (torch.profiler), the
    device's busy share of the host wall time around it, and its device
    operations (of them the layout transposes, cuDNN's convolution kernels
    and the other GEMM kernels). ``device_busy_us`` sums the operations'
    times; ``device_union_us`` is the time at least one ran (the union of
    their intervals), which is less where operations overlap (a graph
    replay may run them concurrently), and ``union_share`` its share of
    the wall."""
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
    union_us = _union_us(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    kinds = {"transpose_ops": 0, "conv_ops": 0, "gemm_ops": 0}
    for n, _, c in kernels:
        for kind, pattern in (("transpose_ops", _TRANSPOSE_RE),
                              ("conv_ops", _CONV_RE),
                              ("gemm_ops", _GEMM_RE)):
            if pattern.search(n):
                kinds[kind] += c
                break
    return {"phase": phase, "card": card, "wall_us": wall_us,
            "device_busy_us": busy_us, "busy_share": busy_us / wall_us,
            "device_union_us": union_us, "union_share": union_us / wall_us,
            "device_ops": sum(k[2] for k in kernels),
            **kinds,
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


def calibrate_scale(synth, ids, lengths, target: int = FRAME_TARGET
                    ) -> float:
    """The duration scale that puts the longest text at ~``target`` frames
    by ``synth``'s duration probe."""
    scale = 1.0
    for _ in range(8):  # frames are nonlinear in the scale: iterate
        peak = float(synth.predict_frames(ids, lengths, scale).max())
        if peak <= 0:
            scale *= 64.0
            continue
        if abs(peak - target) / target < 0.03:
            break
        scale *= target / peak
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
    frames through the short path (→ vocoder_tc32.cu in both), then three
    more lengths twice, one graph a length, replays bitwise eager. Each stream
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
    # the short path is one graph per length: three more lengths, each
    # twice (a first call, then a replay), bitwise the eager call
    sv = ss["f32"].vocoder
    lengths = (17, W // 2, W)
    held_before = sv.graphs.stats()
    with graph_mode("eager"):
        want = [sv.synthesize(mels["f32"][1][:n]) for n in lengths]
    for _ in range(2):
        for n, w in zip(lengths, want):
            if not np.array_equal(sv.synthesize(mels["f32"][1][:n]), w):
                raise RuntimeError(f"short path of {n} frames: replay "
                                   "differs from eager")
    held_after = sv.graphs.stats()
    if held_after["graphs"] - held_before["graphs"] != len(lengths) \
            or held_after["replays"] - held_before["replays"] != len(lengths):
        raise RuntimeError(f"short path graphs: {held_before} before "
                           f"{lengths}, {held_after} after")
    short_graphs = {"lengths": list(lengths), "before": held_before,
                    "after": held_after}
    launches = counters.read()
    if launches["fused_vocoder_tc"] < 1 or launches["fused_vocoder_tc32"] < 1:
        raise RuntimeError(f"streaming skipped a kernel: {launches}")

    out = {"phase": "streaming", "card": card, "launches": launches,
           "chunk_frames": 64, "window_frames": W,
           "short_path_frames": int(short_mel.shape[0]),
           "short_path_graphs": short_graphs}
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
        out[cd] = {
            "kernel": "fused_vocoder_tc32" if cd == "f32"
            else "fused_vocoder_tc",
            "launches": by_part[cd],
            "frames": [int(m.shape[0]) for m in mels[cd]],
            "chunks": [-(-int(m.shape[0]) // 64) for m in mels[cd]],
            "max_abs_err_vs_whole": err_whole,
            "max_abs_err_vs_plain": err_plain,
            "short_path_max_abs_err": err_short,
            # warm: every text has streamed once above
            **stream_timing(s, scale, sample_rate),
            "chunk_device_ms": chunk_ms, "chunk_plain_ms": plain_ms,
            "chunk_bound_ms": chunk_bound, "chunk_bound_by": chunk_bound_by,
            "chunk_shape": list(win.shape)}
    emit(out)
    out["streamers"], out["streams"] = ss, streams
    return out


def stream_timing(s, scale: float, sample_rate: int, n: int = 12) -> dict:
    """``n`` streams of the eight texts in turn through ``s``: the median
    (and range) of the host wall to the first chunk, of the host wall a
    later chunk and of the real-time factor."""
    first, rtf, per_chunk = [], [], []
    for i in range(n):
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
    return {"first_chunk_ms_median": float(np.median(first)),
            "first_chunk_ms_min": min(first),
            "first_chunk_ms_max": max(first),
            "host_ms_per_later_chunk_median": float(np.median(per_chunk)),
            "stream_rtf_median": float(np.median(rtf)),
            "timed_streams": len(first)}


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


# graph replay against disable_graphs() eager: the same kernels in the
# same order on the same inputs, so PCM, mu-law bytes and mel must be
# equal; the f32 stage-1 steps (under deterministic algorithms) are held
# to 1e-6 relative (losses, and each weight tensor against its largest
# value)
GRAPH_TOL = {"pcm_lsb": 0, "mel_abs": 0.0, "loss_rel": 1e-6,
             "params_rel": 1e-6}
# the stage-1 runs held graph against eager: f32 at lr 1e-3 from step 2
GRAPH_TRAIN = {**TRAIN_OVERRIDES, "training.bf16": False,
               "training.transfer_dtype": None,
               "training.warmup_steps": 2, "training.validate_samples": False}
GRAPH_STEPS = 8


def _held_results(got, want, what: str) -> dict:
    """Graph results against eager ones: frames and μ-law bytes equal, PCM
    within ``GRAPH_TOL`` LSB, mel within its abs bar."""
    if len(got) != len(want):
        raise RuntimeError(f"{what}: {len(got)} results, eager {len(want)}")
    lsb, mel = 0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g["frames"] != w["frames"]:
            raise RuntimeError(f"{what} {i}: {g['frames']} frames, eager "
                               f"{w['frames']}")
        lsb = max(lsb, pcm_diff(g["audio_pcm"], w["audio_pcm"],
                                (GRAPH_TOL["pcm_lsb"], None),
                                f"{what} {i}")["max_pcm_lsb"])
        if "audio_mulaw" in w and not np.array_equal(g["audio_mulaw"],
                                                     w["audio_mulaw"]):
            raise RuntimeError(f"{what} {i}: μ-law bytes differ")
        if "mel" in w:
            mel = max(mel, float(np.abs(g["mel"] - w["mel"]).max(initial=0)))
    if mel > GRAPH_TOL["mel_abs"]:
        raise RuntimeError(f"{what}: mel differs by {mel}")
    return {"max_pcm_lsb": lsb, "mel_max_abs": mel}


def _throughput(s, texts, scale: float, iters: int = 5) -> dict:
    """audio-s/s and ms a call of ``iters`` ``synthesize_batch`` calls."""
    torch.cuda.synchronize()
    t0, audio_s = time.perf_counter(), 0.0
    for _ in range(iters):
        res = s.synthesize_batch(texts, scale)
        audio_s += sum(r["frames"] for r in res) * s.upsample / s.sample_rate
    wall = time.perf_counter() - t0
    return {"audio_s_per_s": audio_s / wall, "ms_per_call": wall / iters * 1e3}


def _profile_figures(run, card: str, phase: str) -> dict:
    """The busy share of one ``run()`` and the device's idle time in it
    (the host's time the device does not hide)."""
    p = profile_batch(run, card, phase=phase)
    return {"wall_ms": p["wall_us"] / 1e3,
            "device_busy_ms": p["device_busy_us"] / 1e3,
            "device_union_ms": p["device_union_us"] / 1e3,
            "device_idle_ms": (p["wall_us"] - p["device_union_us"]) / 1e3,
            "busy_share": p["busy_share"], "union_share": p["union_share"],
            "device_ops": p["device_ops"]}


def _stream_chunks(s, texts, scale: float) -> list:
    return [list(s.stream(t, scale)) for t in texts]


def _same_chunks(got, want, what: str) -> int:
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise RuntimeError(f"{what} {i}: {len(g)} chunks, eager {len(w)}")
        for j, (a, b) in enumerate(zip(g, w)):
            if not np.array_equal(a, b):
                raise RuntimeError(f"{what} {i} chunk {j}: max abs "
                                   f"{np.abs(a - b).max(initial=0)}")
        n += len(g)
    return n


def _batcher_run(streamer, scale: float):
    """Four concurrent streams through a StreamBatcher of 4 (a long
    admission window, so the four are admitted as one batch in every
    run); (chunks per stream, chunk calls)."""
    from m2tts_tpu_torch.serving.stream_batcher import StreamBatcher

    sb = StreamBatcher(streamer, max_streams=4, max_wait_ms=500.0)
    try:
        got, _ = run_threads(lambda i: list(sb.stream(
            EVAL_TEXTS[i], scale, timeout=120)), 4)
    finally:
        sb.close()
    return got, sb.chunk_dispatches


def graph_mode(mode: str):
    """A context in which the graph runners replay (``"graph"``) or run
    eagerly (``"eager"``: ``disable_graphs()``)."""
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    return (disable_graphs() if mode == "eager"
            else contextlib.nullcontext())


def _train_steps(trainer, batches: dict, steps: int) -> list:
    """``steps`` micro-steps at each bucket in turn, the step counter (and
    so the dropout noise) advancing; the losses of every step."""
    out = []
    for b in batches.values():
        for _ in range(steps):
            losses = trainer._guarded_step(b)
            if losses is None:
                raise RuntimeError(f"step {trainer.step} hit an OOM")
            out.append({k: v.item() for k, v in losses.items()})
            trainer.step += 1
    return out


def cuda_graphs_phase(synth, synth_f32, scale: float, results: dict,
                      card: str, counters: Counters, buckets: dict) -> dict:
    """One CUDA graph per bucket (``utils/graphs.py``) held against
    ``disable_graphs()`` eager on the card, at the flagship's widths: the
    batch path (batch 64 × the 512-frame bucket, bf16 and f32, int16 and
    μ-law with the mel, two duration scales, two text sets, a same-bucket
    ``synthesize_stream`` of three batches), one stream in each dtype and a
    StreamBatcher of 4, two ``swap_params`` (written in place: they capture
    no graph, and the replays give a fresh Synthesizer's PCM) and two
    sample validations (``validator_swaps``), and 8 f32 stage-1 steps at
    each bucket; with the figures of both: audio-s/s, busy share, first chunk,
    ms a step, and what ``warmup(full=True)`` costs in capture seconds and
    pool memory."""
    import tempfile

    from m2tts_tpu_torch.models.tts_model import build_model, init_params
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer
    from m2tts_tpu_torch.training.trainer import Stage1Trainer
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING)
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    _mode = graph_mode
    t_phase = time.perf_counter()
    counters.zero()
    out = {"phase": "cuda_graphs", "card": card, "tol": GRAPH_TOL}
    runners = []

    # ---- the batch path: replays against eager, one bucket
    sets = [(EVAL_TEXTS * 8)[:64],
            ((EVAL_TEXTS[3:] + EVAL_TEXTS[:3]) * 8)[:64]]
    scales = (scale, 0.95 * scale)
    batch = {}
    for cd, s in (("bf16", synth), ("f32", synth_f32)):
        worst = {"max_pcm_lsb": 0, "mel_max_abs": 0.0}
        for texts in sets:
            packed = pipeline.encode_packed_batch(
                s.text_processor, texts, s.batch_buckets, s.text_buckets)
            for sc in scales:
                peak = int(s.predict_frames(packed[:, :-1], packed[:, -1],
                                            sc)[:len(texts)].max())
                if pipeline._bucket_for(peak, s.frame_buckets) != 512:
                    raise RuntimeError(f"{peak} frames at scale {sc}: not "
                                       "the 512-frame bucket")
                for kw in ({}, {"pcm_format": "mulaw", "want_mel": True}):
                    with disable_graphs():
                        want = s.synthesize_batch(texts, sc, **kw)
                    s.synthesize_batch(texts, sc, **kw)  # a first call
                    got = s.synthesize_batch(texts, sc, **kw)
                    d = _held_results(got, want, f"{cd} batch")
                    worst = {k: max(worst[k], d[k]) for k in worst}
        batches = [sets[0], sets[1], sets[0][::-1]]
        with disable_graphs():
            want = [s.synthesize_batch(b, scale) for b in batches]
        for g, w in zip(s.synthesize_stream(iter(batches), scale), want):
            d = _held_results(g, w, f"{cd} synthesize_stream")
            worst = {k: max(worst[k], d[k]) for k in worst}
        batch[cd] = worst
    out["batch_vs_eager"] = batch

    # ---- figures of the batch path, graph and eager in turns
    texts64 = sets[0]
    turns = []
    for mode in ("eager", "graph", "graph", "eager"):
        with _mode(mode):
            turns.append({"mode": mode,
                          **_throughput(synth, texts64, scale)})
    profiles = {}
    for mode in ("graph", "eager"):
        with _mode(mode):
            profiles[mode] = _profile_figures(
                lambda: synth.synthesize_batch(texts64, scale), card,
                f"cuda_graphs_batch_{mode}")
    out["batch64_bucket512_bf16"] = {"turns": turns, "profile": profiles}

    # ---- warmup(full=True) at these buckets: capture seconds, the pool
    warm = {}
    for cd in ("bf16", "f32"):
        w = pipeline.Synthesizer(synth.model, compute_dtype=cd,
                                 vocoder_backend="auto", device="cuda",
                                 **buckets)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0, a0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        shapes = w.warmup(full=True)
        secs = time.perf_counter() - t0
        torch.cuda.empty_cache()
        stats = w.graph_stats()
        warm[cd] = {"shapes": shapes, "graphs": stats["graphs"],
                    "seconds": secs,
                    "pool_reserved_gb": (torch.cuda.memory_reserved() - r0)
                    / 1e9,
                    "allocated_gb": (torch.cuda.memory_allocated() - a0) / 1e9}
        del w
        torch.cuda.empty_cache()
    out["warmup_full"] = warm

    # ---- swap_params: written in place, so the graphs stay and replay the
    # new weights' output, a fresh Synthesizer's; then two sample
    # validations on two weight sets, the second capturing nothing
    # (in the main path's 512-frame bucket: other weights may pick
    # another bucket through the probe, whose graph is a new key)
    orig = {k: v.detach().clone() for k, v in synth.model.state_dict().items()}
    other = init_params(build_model(FLAGSHIP_MODEL),
                        torch.Generator().manual_seed(SEED + 7), "cuda")
    b512 = {"duration_scale": scale, "max_frames": 512}
    synth.synthesize_batch(EVAL_TEXTS, **b512)
    held_before = synth.graph_stats()
    synth.swap_params(other.state_dict())
    fresh = pipeline.Synthesizer(other, vocoder_backend="auto",
                                 device="cuda", **buckets)
    swapped = {}
    for i in range(2):  # both replays of graphs captured before the swap
        swapped[i] = _held_results(
            synth.synthesize_batch(EVAL_TEXTS, **b512),
            fresh.synthesize_batch(EVAL_TEXTS, **b512), "after swap_params")
    synth.swap_params(orig)
    restored = _held_results(synth.synthesize_batch(EVAL_TEXTS, scale),
                             results["bf16"], "swapped back")
    held_after = synth.graph_stats()
    if held_after["graphs"] != held_before["graphs"]:
        raise RuntimeError(f"swap_params captured graphs: {held_before} "
                           f"before two swaps, {held_after} after")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_val_") as vdir:
        out["swap_params"] = {"vs_fresh": swapped[1], "restored": restored,
                              "graphs_before": held_before,
                              "graphs_after": held_after,
                              "validator": validator_swaps(
                                  orig, other.state_dict(), scale, vdir)}
    del fresh, other, orig

    # ---- streaming: one stream a dtype, a StreamBatcher of 4
    ss = {cd: StreamingSynthesizer(synth.model, chunk_frames=64,
                                   max_frames=512, text_bucket=128,
                                   compute_dtype=cd, device="cuda")
          for cd in ("f32", "bf16")}
    stream = {}
    for cd, st in ss.items():
        with disable_graphs():
            want = _stream_chunks(st, EVAL_TEXTS, scale)
            eager_t = stream_timing(st, scale, synth.sample_rate)
        n = _same_chunks(_stream_chunks(st, EVAL_TEXTS, scale), want,
                         f"{cd} stream")  # first calls
        n += _same_chunks(_stream_chunks(st, EVAL_TEXTS, scale), want,
                          f"{cd} stream")  # replays
        stream[cd] = {"chunks_equal": n, "graph": stream_timing(
            st, scale, synth.sample_rate), "eager": eager_t}
        runners += [st.graphs, st.vocoder.graphs]
    with disable_graphs():
        want, calls_eager = _batcher_run(ss["bf16"], scale)
    got, calls_graph = _batcher_run(ss["bf16"], scale)
    n = _same_chunks(got, want, "batched stream")
    got, _ = _batcher_run(ss["bf16"], scale)
    n += _same_chunks(got, want, "batched stream")
    stream["batcher_bf16"] = {"streams": 4, "chunks_equal": n,
                              "chunk_calls_eager": calls_eager,
                              "chunk_calls_graph": calls_graph}
    out["streaming"] = stream

    # ---- stage 1: 8 f32 steps a bucket, graph against eager; then the
    # bf16 flagship's ms a step and busy share both ways
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs_") as tdir:
        tr = {mode: Stage1Trainer(train_config(
            FLAGSHIP_MODEL, FLAGSHIP_TRAINING, f"{tdir}/{mode}",
            overrides=GRAPH_TRAIN), device="cuda")
            for mode in ("eager", "graph")}
        tbatches = bucket_batches(tr["eager"], tr["eager"]._put)
        # without deterministic algorithms two eager runs part too: the
        # backward's atomics (gather's scatter-add, cuDNN's weight
        # gradients) round differently run to run, and Adam moves a
        # weight whose gradient is rounding noise by ±lr a step
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        try:
            with disable_graphs():
                le = _train_steps(tr["eager"], tbatches, GRAPH_STEPS)
            lg = _train_steps(tr["graph"], tbatches, GRAPH_STEPS)
        finally:
            torch.use_deterministic_algorithms(False)
        loss_rel = max(abs(g[k] - e[k]) / max(abs(e[k]), 1e-30)
                       for g, e in zip(lg, le) for k in e)
        sd_e, sd_g = (tr[m].model.state_dict() for m in ("eager", "graph"))
        params_rel = max(((sd_g[k] - v).abs().max()
                          / v.abs().max().clamp_min(1e-30)).item()
                         for k, v in sd_e.items())
        moved = max((sd_e[k] - v.cuda()).abs().max().item() for k, v in
                    tr["graph"]._oom_snapshot[0]["params"].items())
        if loss_rel > GRAPH_TOL["loss_rel"] \
                or params_rel > GRAPH_TOL["params_rel"] or moved <= 0:
            raise RuntimeError(f"stage-1 graph vs eager: losses {loss_rel}, "
                               f"params {params_rel} (moved {moved})")
        train = {"steps": len(lg), "buckets": [list(k) for k in tbatches],
                 "loss_max_rel": loss_rel, "params_max_rel": params_rel,
                 "weights_moved_max_abs": moved,
                 "graphs": tr["graph"]._graphs.stats()["graphs"]}
        del tr, sd_e, sd_g
        bf = Stage1Trainer(train_config(FLAGSHIP_MODEL, FLAGSHIP_TRAINING,
                                        f"{tdir}/bf16"), device="cuda")
        bb = bucket_batches(bf, bf._put)
        ms = {}
        for mode in ("eager", "graph", "graph", "eager"):
            with _mode(mode):
                ms.setdefault(mode, []).append(
                    {f"{t},{m}": step_ms(bf._train_step, b)
                     for (t, m), b in bb.items()})
        b512 = bb[tuple(bf.buckets[1])]
        prof = {}
        for mode in ("graph", "eager"):
            with _mode(mode):
                prof[mode] = _profile_figures(
                    lambda: [bf._train_step(b512) for _ in range(5)], card,
                    f"cuda_graphs_train_{mode}")
        train["bf16_ms_per_step_by_bucket"] = ms
        train["bf16_profile_5_steps_128_512"] = prof
        runners.append(bf._graphs)
        bf.close()
        del bf, bb, b512
    out["stage1"] = train
    torch.cuda.empty_cache()

    runners += [synth._graphs, synth_f32._graphs]
    out["graphs_held"] = sum(len(r) for r in runners)
    out["launches"] = counters.read()
    if min(out["launches"][k] for k in ("fused_vocoder_tc",
                                        "fused_vocoder_tc32")) < 1:
        raise RuntimeError(f"cuda_graphs skipped a kernel: {out['launches']}")

    # ---- frame_probe='host' against 'device': launches of the host-probe
    # Synthesizer's own calls only
    t_host = time.perf_counter()
    out["host_probe"] = host_probe_figures(synth, scale, buckets, counters)
    out["host_probe"]["seconds"] = time.perf_counter() - t_host
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


SPLIT_PARTS = ("g2p_pack", "probe", "enqueue", "fetch", "collect")
HOST_PROBE_SCALES = (0.8, 1.0, 1.3, 3.0)  # times the calibrated scale


@contextlib.contextmanager
def split_timers(s):
    """Host-clock seconds of the parts of ``s``'s batch calls while the
    block runs: ``g2p_pack`` (``encode_packed_batch``, ``_to_device``),
    ``probe`` (``_frame_totals``: the device probe's replay and blocking
    fetch, or the CPU run), ``enqueue`` (``_run``: the synthesis replay's
    launch), ``fetch`` (``_fetch``: waits for the device, copies the PCM)
    and ``collect`` (``_collect`` without its fetch), summed."""
    from m2tts_tpu_torch.serving import pipeline

    acc = dict.fromkeys(SPLIT_PARTS + ("collect_and_fetch",), 0.0)

    def timed(fn, part):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[part] += time.perf_counter() - t0
        return run

    encode = pipeline.encode_packed_batch
    pipeline.encode_packed_batch = timed(encode, "g2p_pack")
    for name, part in (("_to_device", "g2p_pack"), ("_frame_totals", "probe"),
                       ("_run", "enqueue"), ("_fetch", "fetch"),
                       ("_collect", "collect_and_fetch")):
        setattr(s, name, timed(getattr(s, name), part))
    try:
        yield acc
    finally:
        pipeline.encode_packed_batch = encode
        for name in ("_to_device", "_frame_totals", "_run", "_fetch",
                     "_collect"):
            delattr(s, name)
        acc["collect"] = acc.pop("collect_and_fetch") - acc["fetch"]


def _split_call(s, texts, scale: float):
    """One ``synthesize_batch`` call: (its wall and host split in ms, its
    results)."""
    with split_timers(s) as acc:
        t0 = time.perf_counter()
        res = s.synthesize_batch(texts, scale)
        wall = time.perf_counter() - t0
    split = {k: acc[k] * 1e3 for k in SPLIT_PARTS}
    return {"wall_ms": wall * 1e3, **split,
            "other_ms": wall * 1e3 - sum(split.values()),
            "audio_s": sum(r["frames"] for r in res) * s.upsample
            / s.sample_rate}, res


def _split_summary(runs) -> dict:
    wall = sorted(r["wall_ms"] for r in runs)
    return {"wall_ms_median": wall[len(wall) // 2],
            "wall_ms_min": wall[0], "wall_ms_max": wall[-1],
            "audio_s_per_s": sum(r["audio_s"] for r in runs)
            / (sum(wall) / 1e3),
            "split_ms_mean": {k: sum(r[k] for r in runs) / len(runs)
                              for k in SPLIT_PARTS + ("other_ms",)}}


def _frame_buckets(s_host, s_dev, texts, scale: float):
    """(host counts, device counts, host bucket, device bucket) of a batch:
    the routing each probe gives it (the host's with the guard)."""
    from m2tts_tpu_torch.serving import pipeline

    packed = pipeline.encode_packed_batch(
        s_dev.text_processor, texts, s_dev.batch_buckets, s_dev.text_buckets)
    n = len(texts)
    host = s_host.predict_frames_host(packed[:, :-1], packed[:, -1], scale)
    dev = s_dev.predict_frames(packed[:, :-1], packed[:, -1], scale)
    return (host[:n], dev[:n],
            pipeline._bucket_for(int(host[:n].max())
                                 + pipeline.HOST_PROBE_GUARD,
                                 s_dev.frame_buckets),
            pipeline._bucket_for(int(dev[:n].max()), s_dev.frame_buckets))


def host_probe_figures(synth, scale: float, buckets: dict,
                       counters: Counters, iters: int = 5) -> dict:
    """``frame_probe='host'`` against the main path's ``'device'``
    Synthesizer (bf16, ``vocoder_tc.cu``) on its weights, as graph
    replays: batch 1 (the longest text) and batch 64 × the 512-frame
    bucket. After the host Synthesizer's ``warmup(full=True)`` its calls
    must capture no graph; where both probes pick one bucket the PCM must
    be equal (0 LSB). ``launches`` counts the host Synthesizer's own calls
    only (the counters zeroed just before each, read just after) and must
    be its calls × the vocoder's stages. Times: each call's wall and host
    split (``split_timers``) in turns host, device, device, host, then the
    device Synthesizer's ``_throughput`` loop on the batch-64 request.
    Then the largest |host − device| frame count over the eight texts at
    ``HOST_PROBE_SCALES``, with cuDNN's TF32 off and on (the device probe
    of a fresh Synthesizer captured under each)."""
    from m2tts_tpu_torch.serving import pipeline

    sh = pipeline.Synthesizer(synth.model, frame_probe="host",
                              vocoder_backend="auto", device=synth.device,
                              **buckets)
    if (sh.frame_probe, sh.vocoder_backend, sh.compute_dtype) != \
            ("host", synth.vocoder_backend, synth.compute_dtype):
        raise RuntimeError("host-probe Synthesizer resolved to "
                           f"{sh.frame_probe}/{sh.vocoder_backend}/"
                           f"{sh.compute_dtype}")
    out = {"threads": torch.get_num_threads(), "cpu_count": os.cpu_count(),
           "guard": pipeline.HOST_PROBE_GUARD}
    t0 = time.perf_counter()
    out["warmup_shapes"] = sh.warmup(full=True)
    out["warmup_seconds"] = time.perf_counter() - t0
    held = sh.graph_stats()["graphs"]

    launches, n_calls = dict.fromkeys(Counters.NAMES, 0), 0

    def host_call(fn, *args):  # one call of sh, counted on its own
        nonlocal n_calls
        counters.zero()
        try:
            return fn(*args)
        finally:
            for k, v in counters.read().items():
                launches[k] += v
            n_calls += 1

    ids, lengths = packed_eval_texts(synth)
    longest = int(np.argmax(synth.predict_frames(ids, lengths, scale)[
        :len(EVAL_TEXTS)]))
    requests = {"batch1": [EVAL_TEXTS[longest]],
                "batch64": (EVAL_TEXTS * 8)[:64]}
    routes, held_pcm = {}, {}
    for name, texts in requests.items():
        host, dev, hb, db = _frame_buckets(sh, synth, texts, scale)
        routes[name] = {"host_bucket": hb, "device_bucket": db,
                        "max_count_gap": int(np.abs(host - dev).max())}
        if db != 512:
            raise RuntimeError(f"{name}: the device probe picked {db}, "
                               "not the 512-frame bucket")
        got = host_call(sh.synthesize_batch, texts, scale)
        want = synth.synthesize_batch(texts, scale)
        if hb == db:
            held_pcm[name] = _held_results(got, want, f"host probe {name}")
    out["routes"], out["host_vs_device"] = routes, held_pcm

    calls = {name: {"host": [], "device": []} for name in requests}
    for probe in ("host", "device", "device", "host"):
        for name, texts in requests.items():
            torch.cuda.synchronize()
            calls[name][probe] += [
                (host_call(_split_call, sh, texts, scale) if probe == "host"
                 else _split_call(synth, texts, scale))[0]
                for _ in range(iters)]
    out["times"] = {name: {probe: _split_summary(runs)
                           for probe, runs in by_probe.items()}
                    for name, by_probe in calls.items()}
    out["batch64_device_throughput"] = _throughput(
        synth, requests["batch64"], scale, iters)
    captured = sh.graph_stats()["graphs"] - held
    if captured:
        raise RuntimeError(f"the host path captured {captured} graphs after "
                           "its warmup")
    out["graphs_after_warmup"] = {"held": held, "captured": captured}
    stages = len(synth.model.upsample_rates)
    want_launches = {**dict.fromkeys(Counters.NAMES, 0),
                     "fused_vocoder_tc": n_calls * stages}
    if launches != want_launches:
        raise RuntimeError(f"the host path's {n_calls} calls launched "
                           f"{launches}, not {want_launches}")
    out["launches"], out["calls"] = launches, n_calls

    gaps = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            sd = pipeline.Synthesizer(synth.model, vocoder_backend="auto",
                                      device=synth.device, **buckets)
            worst, flips = 0, 0
            for k in HOST_PROBE_SCALES:
                host, dev, hb, db = _frame_buckets(sh, sd, EVAL_TEXTS,
                                                   k * scale)
                worst = max(worst, int(np.abs(host - dev).max()))
                flips += hb != db
            gaps["cudnn_tf32_on" if tf32 else "cudnn_tf32_off"] = {
                "max_count_gap": worst, "bucket_differs": flips}
            del sd
        finally:
            torch.backends.cudnn.allow_tf32 = False
    out["frame_count_gap"] = gaps
    del sh
    torch.cuda.empty_cache()
    return out


def validator_swaps(first: dict, second: dict, scale: float,
                    out_dir: str) -> dict:
    """Two sample validations (``training/validation.py``, the f32
    ``torch``-backend yardstick on the eight texts) on ``first`` then
    ``second``: the first captures the validator's graph, the second swaps
    in place and captures none; then a synthesis at ``scale`` in the same
    bucket (a replay) against a fresh validator's on ``second`` at 0
    LSB."""
    from m2tts_tpu_torch.models.tts_model import build_model
    from m2tts_tpu_torch.training.validation import SampleValidator
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    def validator(name):
        return SampleValidator(build_model(FLAGSHIP_MODEL).cuda(),
                               eval_texts=EVAL_TEXTS,
                               samples_dir=f"{out_dir}/{name}",
                               text_bucket=128, frame_bucket=512,
                               device="cuda")

    v, fresh = validator("swapped"), validator("fresh")
    runs = [v.run(first, 1)]
    graphs = v._synth.graph_stats()
    runs.append(v.run(second, 2))
    fresh.run(second, 2)
    if v._synth.graph_stats()["graphs"] != graphs["graphs"] \
            or graphs["graphs"] < 1 \
            or not all(r.get("validation_completed") for r in runs):
        raise RuntimeError(f"validator: {graphs} after one run, "
                           f"{v._synth.graph_stats()} after two; {runs}")
    kw = {"duration_scale": scale, "max_frames": 512}
    held_out = _held_results(v._synth.synthesize_batch(EVAL_TEXTS, **kw),
                             fresh._synth.synthesize_batch(EVAL_TEXTS, **kw),
                             "validator after a swap")
    return {"graphs_after_one_run": graphs,
            "graphs_after_two": v._synth.graph_stats(),
            "vs_fresh": held_out,
            "estimated_mos": [r.get("estimated_mos") for r in runs]}


def train_config(model: dict, training: dict, out_dir: str,
                 overrides=TRAIN_OVERRIDES, **extra):
    """The flagship-style config with ``overrides`` (and ``extra``) applied
    and every output under ``out_dir``."""
    from m2tts_tpu_torch.utils.config import Config

    cfg = Config({"model": model, **training})
    for key, value in {**overrides, **extra}.items():
        cfg.set(key, value)
    cfg.set("paths.output_dir", out_dir)
    cfg.set("paths.checkpoint_dir", f"{out_dir}/checkpoints")
    cfg.set("paths.log_dir", f"{out_dir}/logs")
    return cfg


def bucket_batches(trainer, put, audio_samples=None) -> dict:
    """One device batch (``put`` of the host batch) of each bucket shape
    (leftover groups padded by cycling, as ``make_batches`` pads them with
    ``drop_last=False``)."""
    from m2tts_tpu_torch.data.dataset import make_batches

    out = {}
    for b in make_batches(trainer.dataset, trainer.batch_size,
                          trainer.buckets, seed=0, shuffle=False,
                          drop_last=False, audio_samples=audio_samples):
        key = (b["phoneme_ids"].shape[1], b["mel"].shape[1])
        if key not in out:
            out[key] = put(b)
    return out


def step_ms(step, batch, iters: int = 8, warmup: int = 2) -> float:
    """Host wall ms per train step ``step(batch)``, ``iters`` steps between
    two synchronisations (no host read inside, as in the training loop)."""
    for _ in range(warmup):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _read_metrics(log_dir: str):
    import csv

    with open(os.path.join(log_dir, "metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


def train_run(cfg, card: str, dataset: str = "DummyDataset") -> dict:
    """One training run of ``cfg`` on the card, on a dataset of class
    ``dataset`` (the data-free ``DummyDataset`` unless the config names a
    corpus): validation before and after, the run's wall time and peak
    memory, the logged losses; the trainer, its final weights and the
    weights it pinned as best."""
    from m2tts_tpu_torch.training.trainer import Stage1Trainer

    trainer = Stage1Trainer(cfg, device="cuda")
    if type(trainer.dataset).__name__ != dataset:
        raise RuntimeError(f"expected a {dataset}, got "
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
    batches = bucket_batches(trainer, trainer._put)
    reports["ms_per_step_by_bucket"] = {
        f"{t},{m}": step_ms(trainer._train_step, b)
        for (t, m), b in batches.items()}
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



def _eval_weights(trainer) -> dict:
    """Host-independent copies of the weights a stage-2 trainer scores and
    serves (its EMA)."""
    return {k: v.detach().clone() for k, v in trainer._eval_params().items()}


def _is_loss(key: str) -> bool:
    return key.endswith("_loss") or key == "adv_guard"


def stage2_run(cfg, card: str, dataset: str = "DummyDataset") -> dict:
    """One stage-2 run of ``cfg`` on the card, on a dataset of class
    ``dataset``, warm-started from the stage-1 checkpoint it names: the
    run's wall time and peak memory, every logged loss, the validation's
    quality metrics; the trainer, its final EMA weights and the EMA it
    pinned as best."""
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.checkpoint import load_for_inference

    trainer = Stage2Trainer(cfg, device="cuda")
    if type(trainer.dataset).__name__ != dataset:
        raise RuntimeError(f"expected a {dataset}, got "
                           f"{type(trainer.dataset).__name__}")
    init_from = cfg.get("training.init_generator_from")
    stage1, _, stage1_step = load_for_inference(init_from)
    model_sd = trainer.model.state_dict()
    if not all(torch.equal(model_sd[k].cpu(), v) for k, v in stage1.items()):
        raise RuntimeError(f"the generator was not warm-started from "
                           f"{init_from}")
    best = {}
    pin = trainer.save_best_checkpoint

    def save_best(score):  # keep the pinned EMA for train_stage2_to_serve
        best.update(step=trainer.step, score=score,
                    weights=_eval_weights(trainer))
        pin(score)

    trainer.save_best_checkpoint = save_best
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    final = _eval_weights(trainer)
    rows = _read_metrics(cfg.get("paths.log_dir"))
    logged = {int(r["step"]): {k: float(v) for k, v in r.items()
                               if v and _is_loss(k)}
              for r in rows if r.get("total_loss")}
    val = {k[len("val_"):]: float(v) for r in rows for k, v in r.items()
           if k.startswith("val_") and v}
    values = [v for losses in logged.values() for v in losses.values()]
    steps = int(cfg.get("training.max_steps"))
    if len(logged) != steps // int(cfg.get("training.log_every")) \
            or not all(map(math.isfinite, values + list(val.values()))):
        raise RuntimeError(f"non-finite or missing losses: {logged} {val}")
    need = ("quality_score_audio", "utt_stoi", "mcd", "spectral_loss")
    if any(k not in val for k in need):
        raise RuntimeError(f"validation lacks {need}: {sorted(val)}")
    if trainer.step != steps or trainer.ckpt.latest_step() != steps \
            or best.get("step") != steps:
        raise RuntimeError(f"run ended at step {trainer.step}, checkpoint "
                           f"{trainer.ckpt.latest_step()}, best "
                           f"{best.get('step')}")
    return {"trainer": trainer, "final": final, "best": best, "report": {
        "steps": steps, "wall_s": wall, "steps_per_s": steps / wall,
        "logged_steps_per_s": [float(r["steps_per_sec"]) for r in rows
                               if r.get("steps_per_sec")],
        "max_memory_allocated_gb": peak / 1e9,
        "losses_logged": logged, "validation": val,
        "warm_start_step": stage1_step, "best_step": best["step"],
        "checkpoints": trainer.ckpt.all_steps()}}


def train_stage2_phase(out_dir: str, card: str, stage1_dir, stage1_xl_dir,
                       profile: bool = False) -> dict:
    """30 flagship GAN steps through the DevicePrefetcher and 30 with the
    device data cache, both warm-started from the stage-1 checkpoint; ms
    per fused step by bucket; with ``profile`` the device time of 3 steps
    at the (128, 512) bucket; then 5 steps at the stage-2 XL config's
    widths, warm-started from the stage-1 XL run."""
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL, STAGE2_TRAINING,
                                              STAGE2_XL_MODEL,
                                              STAGE2_XL_TRAINING)

    t0 = time.perf_counter()
    runs, reports = {}, {}
    for name, cache in (("prefetcher", False), ("device_cache", True)):
        cfg = train_config(FLAGSHIP_MODEL, STAGE2_TRAINING,
                           f"{out_dir}/{name}", overrides=STAGE2_OVERRIDES,
                           **{"training.device_data_cache": cache,
                              "training.init_generator_from": str(stage1_dir)})
        runs[name] = stage2_run(cfg, card)
        reports[name] = runs[name]["report"]
    trainer = runs["prefetcher"]["trainer"]
    rng = np.random.default_rng(SEED)  # segments off the training stream
    batches = bucket_batches(
        trainer, lambda b: trainer._transfer.transfer(trainer._prepare(b, rng)),
        trainer._max_audio_samples())
    reports["ms_per_step_by_bucket"] = {
        f"{t},{m}": step_ms(trainer.train_step, b)
        for (t, m), b in batches.items()}
    tcfg = trainer.config.get("training")
    out = {"phase": "train_stage2", "card": card,
           "overrides": STAGE2_OVERRIDES, "batch_size": trainer.batch_size,
           "bf16": trainer.bf16, "segment_samples":
               trainer.seg_frames * trainer.upsample,
           "spectral_norm": trainer.discriminator.spectral_norm,
           "disc_lowering": trainer.disc_lowering,
           "ema_decay": trainer.ema_decay, "buckets": trainer.buckets,
           "dataset_size": len(trainer.dataset),
           "learning_rate": tcfg.get("learning_rate"),
           "discriminator_params": sum(p.numel() for p in trainer.d_params),
           **reports, "seconds": time.perf_counter() - t0}
    emit(out)
    if profile:
        b512 = batches[tuple(trainer.buckets[1])]
        emit(profile_batch(lambda: [trainer.train_step(b512)
                                    for _ in range(3)],
                           card, phase="train_stage2_profile"))
    del batches

    # the stage-2 XL config: device cache and both adaptive guards on
    cfg = train_config(STAGE2_XL_MODEL, STAGE2_XL_TRAINING, f"{out_dir}/xl",
                       overrides=STAGE2_OVERRIDES,
                       **{"training.max_steps": STAGE2_XL_STEPS,
                          "training.log_every": STAGE2_XL_STEPS,
                          "training.validate_every": 1000,
                          "training.save_every": 1000,
                          "training.init_generator_from": str(stage1_xl_dir)})
    t_xl = time.perf_counter()
    xl = Stage2Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = xl.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = {k: v for k, v in last.items() if _is_loss(k)}
    if xl.step != STAGE2_XL_STEPS or "adv_guard" not in losses \
            or not all(map(math.isfinite, losses.values())):
        raise RuntimeError(f"stage-2 XL run: step {xl.step}, losses {last}")
    emit({"phase": "train_stage2_xl", "card": card, "steps": STAGE2_XL_STEPS,
          "params": sum(p.numel() for p in xl.g_params),
          "device_data_cache": xl.device_data_cache,
          "guard_floors": [xl.adaptive_adv_floor, xl.adaptive_d_lr_floor],
          "wall_s": wall, "steps_per_s": STAGE2_XL_STEPS / wall,
          "logged_steps_per_s": last["steps_per_sec"], "losses": losses,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t_xl})
    xl.close()
    del xl
    torch.cuda.empty_cache()
    out["runs"] = runs
    return out


def train_stage2_vs_cpu_phase(out_dir: str, card: str) -> dict:
    """Two f32 fused GAN steps of the flagship at the (128, 512) bucket,
    batch 8, 8192-sample segments, dropout 0, the recipe's lr held
    constant, both guards on, on the card and on the CPU from the same
    weights and batch, TF32 off on the card; and the same two steps in f64
    on the CPU, the reference the generator's side is held to
    (``STAGE2_VS_CPU``). Eager (``disable_graphs()``): the gradients are
    copied to the host inside the step."""
    from m2tts_tpu_torch.data.dataset import make_batches
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, STAGE2_TRAINING
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = STAGE2_TRAINING["training"]["learning_rate"]
    extra = {"model.text_encoder.dropout": 0.0, "training.bf16": False,
             "training.batch_size": 8, "training.audio_segment_len": 8192,
             "training.lr_scheduler": "constant", "training.warmup_steps": 0,
             "training.learning_rate": lr,
             "training.adversarial_warmup_steps": 2,
             "training.adaptive_adv_dloss_floor": 2.0,
             "training.adaptive_d_lr_floor": 2.0}
    tr = {run: Stage2Trainer(train_config(
        FLAGSHIP_MODEL, STAGE2_TRAINING, f"{out_dir}/vs_cpu_{run}",
        overrides=STAGE2_OVERRIDES, **extra),
        device="cuda" if run == "cuda" else "cpu")
        for run in ("cpu", "cuda", "f64")}
    for run in ("cuda", "f64"):
        t = tr[run]
        t.model.load_state_dict(tr["cpu"].model.state_dict())
        t.discriminator.load_state_dict(tr["cpu"].discriminator.state_dict())
        if run == "f64":  # the parameters (and so the optimizers') in f64
            t.model.double()
            t.discriminator.double()
        t.ema = [p.detach().clone() for p in t.g_params]
    grads = {}
    for run, t in tr.items():  # record each update's gradients
        for net in ("d", "g"):
            def update(g, *args, _fn=getattr(t, f"_{net}_update"),
                       _key=(run, net)):
                grads[_key] = [x.detach().double().cpu() for x in g]
                return _fn(g, *args)

            setattr(t, f"_{net}_update", update)
    frames = tr["cpu"].buckets[1][1]  # the (128, 512) bucket
    host = next(b for b in make_batches(
        tr["cpu"].dataset, 8, tr["cpu"].buckets, seed=0,
        audio_samples=tr["cpu"]._max_audio_samples())
        if b["mel"].shape[1] == frames)
    host = tr["cpu"]._prepare(host, np.random.default_rng(SEED))
    batches = {"cpu": host, "cuda": host, "f64": {
        k: v.astype(np.float64) if getattr(v, "dtype", None) == np.float32
        else v for k, v in host.items()}}

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def params(run, module):
        return {k: v.detach().double().cpu() for k, v in
                getattr(tr[run], module).state_dict().items()}

    steps = []
    for _ in range(2):
        with disable_graphs():
            m = {run: {k: v.item() for k, v in tr[run].train_step(
                dict(batches[run])).items()} for run in tr}
        if not set(m["cpu"]) == set(m["cuda"]) == set(m["f64"]):
            raise RuntimeError(f"metric keys differ: {m}")
        st = {"losses_cpu": m["cpu"],
              "loss_rel": {k: rel(m["cuda"][k], v)
                           for k, v in m["cpu"].items()}}
        norm = {k: math.sqrt(sum(float((x ** 2).sum()) for x in g))
                for k, g in grads.items()}
        d_want = params("cpu", "discriminator")
        st["d"] = {"grad_norm": {r: norm[(r, "d")] for r in tr},
                   "grad_norm_rel": rel(norm[("cuda", "d")],
                                        norm[("cpu", "d")]),
                   "params_max_abs": max(
                       (v - d_want[k]).abs().max().item()
                       for k, v in params("cuda", "discriminator").items())}
        g_ref, p_ref = grads[("f64", "g")], params("f64", "model")
        st["g"] = {"grad_norm": {r: norm[(r, "g")] for r in tr}}
        for run in ("cpu", "cuda"):
            err = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in
                                zip(grads[(run, "g")], g_ref)))
            off = sum(int(((v - p_ref[k]).abs()
                           > STAGE2_VS_CPU["params_lr"] * lr).sum())
                      for k, v in params(run, "model").items())
            st["g"][run] = {
                "grad_norm_rel_f64": rel(norm[(run, "g")], norm[("f64", "g")]),
                "grad_rel_l2_f64": err / norm[("f64", "g")],
                "params_off_lr10_f64": off}
        st["g"]["params_max_abs_vs_cpu"] = max(
            (v - params("cpu", "model")[k]).abs().max().item()
            for k, v in params("cuda", "model").items())
        steps.append(st)
    bars = STAGE2_VS_CPU
    for st in steps:
        g_cpu, g_card = st["g"]["cpu"], st["g"]["cuda"]
        radius = (bars["g_vs_f64"] * g_cpu["grad_rel_l2_f64"]
                  + bars["g_floor"])
        if (max(st["loss_rel"].values()) > bars["loss_rel"]
                or st["d"]["grad_norm_rel"] > bars["grad_norm_rel"]
                or st["d"]["params_max_abs"] > bars["params_lr"] * lr
                or g_card["grad_rel_l2_f64"] > radius
                or g_card["grad_norm_rel_f64"] > radius
                or g_card["params_off_lr10_f64"]
                > bars["g_vs_f64"] * g_cpu["params_off_lr10_f64"]):
            raise RuntimeError(f"GAN step on the card vs the CPU: {st}")
    out = {"phase": "train_stage2_vs_cpu", "card": card, "bars": bars,
           "learning_rate": lr,
           "shape": list(host["mel"].shape),
           "segment_samples": host["audio_seg"].shape[1],
           "n_generator_params": sum(p.numel() for p in tr["cpu"].g_params),
           "tf32": False, "steps": steps,
           "seconds": time.perf_counter() - t0}
    emit(out)
    for t in tr.values():
        t.close()
    return out


def train_stage2_to_serve_phase(stage2: dict, buckets: dict, card: str,
                                counters: Counters, lsb_bar) -> dict:
    """The prefetcher run's latest and best stage-2 checkpoints served by
    ``from_checkpoint`` (``auto``: bf16 on ``vocoder_tc.cu``; both load
    ``generator_ema``) on the eight texts, against Synthesizers on the
    trainer's in-memory EMA weights (0 LSB) and against the plain ``mm``
    vocoder on the same weights (the bf16 bar)."""
    from m2tts_tpu_torch.models.tts_model import build_model
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    t0 = time.perf_counter()
    run = stage2["runs"]["prefetcher"]
    ckdir = run["trainer"].ckpt.directory

    def in_memory(weights, backend):
        model = build_model(FLAGSHIP_MODEL)
        model.load_state_dict(weights)
        return pipeline.Synthesizer(model, vocoder_backend=backend,
                                    device="cuda", **buckets)

    served = {k: pipeline.from_checkpoint(
        ckdir, step=None if k == "latest" else "best", device="cuda",
        vocoder_backend="auto", **buckets) for k in ("latest", "best")}
    weights = {"latest": run["final"], "best": run["best"]["weights"]}
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
        raise RuntimeError(f"train_stage2_to_serve skipped the kernel: "
                           f"{launches}")
    out = {"phase": "train_stage2_to_serve", "card": card,
           "launches": launches, "duration_scale": scale}
    for k in served:
        refs = {b: in_memory(weights[k], b).synthesize_batch(
            EVAL_TEXTS, duration_scale=scale) for b in ("auto", "mm")}
        out[k] = {"frames": [r["frames"] for r in got[k]]}
        vs_mm = []
        for i, (a, b, c) in enumerate(zip(got[k], refs["auto"],
                                          refs["mm"])):
            if not a["frames"] == b["frames"] == c["frames"] > 0 \
                    or a.get("truncated") or not np.any(a["audio_pcm"]):
                raise RuntimeError(f"{k} text {i}: frames {a['frames']} vs "
                                   f"{b['frames']} / {c['frames']}, "
                                   f"truncated {a.get('truncated')}")
            pcm_diff(a["audio_pcm"], b["audio_pcm"], (0, None),
                     f"stage-2 {k} checkpoint vs in-memory EMA, text {i}")
            vs_mm.append(pcm_diff(a["audio_pcm"], c["audio_pcm"], lsb_bar,
                                  f"stage-2 {k} checkpoint vs mm, text {i}"))
        out[k].update(max_pcm_lsb_vs_ema=0, max_pcm_lsb_vs_mm=max(
            d["max_pcm_lsb"] for d in vs_mm), mean_pcm_lsb_vs_mm=float(
            np.mean([d["mean_pcm_lsb"] for d in vs_mm])))
    out["checkpoint_steps"] = {"latest": run["trainer"].ckpt.latest_step(),
                               "best": run["best"]["step"]}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# the flagship stage-2 discriminator batch [real; fake]: FLAGSHIP_TRAINING's
# batch 32 × 8192-sample segments
DISC_SHAPE = (64, 8192)
# packed against native on the card (TF32 off): the bars of
# tests/test_disc_packed.py (outputs 1e-4 abs, bf16 outputs 0.05 abs and
# rel) and of tests/test_grouped_conv_wgrad.py (each weight-gradient
# lowering 5e-4 abs and rel). Its f32 gradient bar, 1e-5 abs, is below the
# f32 gradient's own error at this size: at [64, 8192] cuDNN's native f32
# gradient lies up to 8.3e-5 from the same gradient in f64 (sums over
# B·T = 131k terms a weight; the CPU tests' [2, 1024] sums 64× fewer), and
# packed's as far, while the two differ by up to 4.6e-5. So each f32
# gradient tensor of the packed lowering is held to the f64 native one:
# within grad_vs_f64 times native's own distance from it, + f32_grad
DISC_TOL = {"f32_out": 1e-4, "f32_grad": 1e-5, "grad_vs_f64": 2.0,
            "bf16": 0.05, "wgrad": 5e-4}
# a few flagship GAN steps a lowering (FLAGSHIP_TRAINING, no spectral norm),
# warm-started from the stage-1 checkpoint; the rest of the recipe stands
PACKED_OVERRIDES = {"training.max_steps": 6, "training.log_every": 3,
                    "training.validate_every": 1000,
                    "training.save_every": 6}
# one f32 GAN step (TF32 off) with the packed lowering against the same step
# with the native one, from the same weights and batch. The losses and the
# discriminator's gradient (taken before any update) differ only by the two
# lowerings' rounding: relative 1e-5, stage 1's bars. The generator's
# gradient is taken against the updated discriminator: Adam's first update
# moves each weight by about lr·sign(g), so where |g| is near rounding the
# two lowerings can step a weight opposite ways, and the generator's f32
# gradient is ill-conditioned at these weights besides (STAGE2_VS_CPU; the
# card's atomics reorder its sums from run to run). So, as in
# STAGE2_VS_CPU, both f32 runs are held to the same step in f64 (native):
# the packed one within g_vs_f64 times the native one's relative L2
# distance from it (+ g_floor)
PACKED_VS_NATIVE = {"loss_rel": 1e-5, "d_grad_rel_l2": 1e-5,
                    "g_vs_f64": 2.0, "g_floor": 1e-7}


def disc_work(B: int, T: int, scales=(1, 2, 4)) -> dict:
    """FLOPs and bytes of the discriminator on [B, T] from its layer table:
    forward FLOPs (2 a multiply-add, the strided convs at their own taps),
    forward+backward 3× that (the input and the weight gradients); bf16
    bytes of the forward (audio and weights read once, logits and the 18
    feature maps written once) and of the forward+backward (those, and the
    weight and input gradients written once)."""
    from m2tts_tpu_torch.models.discriminator import _LAYERS

    flops, feat, n_w = 0, 0, 0
    for s in scales:
        t, cin = T // s, 1
        for ch, k, stride, g in _LAYERS + ((1, 3, 1, 1),):
            t //= stride
            flops += 2 * B * t * ch * (cin // g) * k
            feat += B * t * ch
            n_w += ch * (cin // g) * k + ch
            cin = ch
    fwd_bytes = 2 * (B * T + n_w + feat)
    return {"fwd_flops": flops, "fwd_bwd_flops": 3 * flops,
            "fwd_bytes": fwd_bytes,
            "fwd_bwd_bytes": fwd_bytes + 2 * (n_w + B * T),
            "weights": n_w}


def _disc_loss(logits, feats):
    """A scalar of every logit and feature map, in f32 (the trainer upcasts
    before its losses): what tests/test_disc_packed.py differentiates."""
    return (sum(l.float().pow(2).mean() for l in logits)
            + sum(f.float().abs().mean() for fs in feats for f in fs))


def disc_lowering_phase(card: str) -> dict:
    """The flagship discriminator (three scales, 16.76 M parameters) on
    [64, 8192], the stage-2 D batch: the packed lowering against the module
    in f32 (outputs, weight and input gradients, each weight-gradient
    lowering) and in bf16 (outputs); ms forward and forward+backward in
    bf16 by CUDA events for native and packed with each weight-gradient
    lowering, beside the FLOP and byte bounds; device operations of one
    forward+backward by kind."""
    from m2tts_tpu_torch.models import discriminator as tdisc
    from m2tts_tpu_torch.models.tts_model import init_params
    from m2tts_tpu_torch.ops.grouped_conv import VARIANTS

    t0 = time.perf_counter()
    disc = init_params(tdisc.MultiScaleDiscriminator(),
                       torch.Generator().manual_seed(SEED), "cuda")
    params = {k: v.detach() for k, v in disc.named_parameters()}
    B, T = DISC_SHAPE
    audio = torch.randn(DISC_SHAPE, generator=torch.Generator().manual_seed(
        SEED + 2)).cuda()

    def apply(p, x, lowering):
        if lowering == "native":
            return torch.func.functional_call(disc, p, (x,))
        return tdisc.packed_multiscale_apply(p, x, wgrad=lowering)

    def leaves(p, x):  # differentiable copies: weights, then the input
        return ({k: v.clone().requires_grad_() for k, v in p.items()},
                x.clone().requires_grad_())

    def fwd_bwd(leaf, lowering):
        p, x = leaf
        return torch.autograd.grad(_disc_loss(*apply(p, x, lowering)),
                                   [x] + list(p.values()))

    def outputs(p, x, lowering):
        with torch.no_grad():
            logits, feats = apply(p, x, lowering)
        return list(logits) + [f for fs in feats for f in fs]

    # f32 (TF32 off): outputs and gradients
    holds = {}
    native_out = outputs(params, audio, "native")
    packed_out = outputs(params, audio, "xla")
    holds["f32_out_max_abs"] = max((a - b).abs().max().item()
                                   for a, b in zip(packed_out, native_out))
    del packed_out
    f32_leaves = leaves(params, audio)
    g_native = fwd_bwd(f32_leaves, "native")
    disc.double()  # the reference gradient: native, in f64
    g_f64 = fwd_bwd(leaves({k: v.detach() for k, v in
                            disc.named_parameters()}, audio.double()),
                    "native")
    disc.float()

    def dist(g):  # max abs distance from f64, per gradient tensor
        return [(a.double() - r).abs().max().item() for a, r in zip(g, g_f64)]

    native_f64 = dist(g_native)
    holds["f32_native_grad_vs_f64_max_abs"] = max(native_f64)
    holds["f32_grad_max_abs"] = {}
    for wg in VARIANTS:
        g = fwd_bwd(f32_leaves, wg)
        err = [(a - b).abs().max().item() for a, b in zip(g, g_native)]
        packed_f64 = dist(g)
        holds["f32_grad_max_abs"][wg] = {
            "vs_native_input": err[0], "vs_native_weights": max(err[1:]),
            "vs_f64": max(packed_f64)}
        for a, b in zip(g, g_native):
            torch.testing.assert_close(a, b, rtol=DISC_TOL["wgrad"],
                                       atol=DISC_TOL["wgrad"])
        if wg == "xla":
            bad = [(i, p, n) for i, (p, n) in enumerate(zip(packed_f64,
                                                             native_f64))
                   if p > DISC_TOL["grad_vs_f64"] * n + DISC_TOL["f32_grad"]]
            if bad:
                raise RuntimeError(f"packed f32 gradients (tensor, packed and"
                                   f" native distance from f64): {bad}")
        del g
    del g_native, g_f64, f32_leaves
    if holds["f32_out_max_abs"] > DISC_TOL["f32_out"]:
        raise RuntimeError(f"packed f32 outputs differ from native by "
                           f"{holds['f32_out_max_abs']}")
    # bf16: outputs
    p16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    a16 = audio.to(torch.bfloat16)
    n16 = outputs(p16, a16, "native")
    k16 = outputs(p16, a16, "xla")
    for a, b in zip(k16, n16):
        torch.testing.assert_close(a.float(), b.float(),
                                   rtol=DISC_TOL["bf16"],
                                   atol=DISC_TOL["bf16"])
    holds["bf16_out_max_abs"] = max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(k16, n16))
    del n16, k16, native_out

    # bf16 times, native first and last
    work = disc_work(B, T)
    bf16_leaves = leaves(p16, a16)
    times, census = {}, {}
    for lowering in ("native", "xla", "pergroup", "dense", "native"):
        t = times.setdefault(lowering, {"fwd_ms": [], "fwd_bwd_ms": []})
        if lowering in ("native", "xla"):
            t["fwd_ms"].append(cuda_time_ms(
                lambda: outputs(p16, a16, lowering), 10))
        t["fwd_bwd_ms"].append(cuda_time_ms(
            lambda: fwd_bwd(bf16_leaves, lowering), 10))
        if lowering not in census:
            census[lowering] = profile_batch(
                lambda: fwd_bwd(bf16_leaves, lowering), card, top=5,
                phase=f"disc_fwd_bwd_{lowering}")
    # the same with cuDNN's autotuner, which the trainer leaves off
    with_benchmark = {}
    torch.backends.cudnn.benchmark = True
    try:
        for lowering in ("native", "xla"):
            with_benchmark[lowering] = cuda_time_ms(
                lambda: fwd_bwd(bf16_leaves, lowering), 10, warmup=3)
    finally:
        torch.backends.cudnn.benchmark = False
    bounds = {}
    for what in ("fwd", "fwd_bwd"):
        ops_ms = work[f"{what}_flops"] / PEAK_FLOPS["bf16"] * 1e3
        bytes_ms = work[f"{what}_bytes"] / HBM_BYTES_PER_S * 1e3
        bounds[what] = {"flop_bound_ms": ops_ms, "byte_bound_ms": bytes_ms,
                        "bound_ms": max(ops_ms, bytes_ms),
                        "bound_by": "operations" if ops_ms >= bytes_ms
                        else "bytes"}
    out = {"phase": "disc_lowering", "card": card, "shape": list(DISC_SHAPE),
           "discriminator_params": work["weights"], "tol": DISC_TOL,
           "tf32": False, "cudnn_benchmark": False, **holds,
           "work": work, "bounds": bounds, "bf16_times": times,
           "bf16_fwd_bwd_ms_cudnn_benchmark": with_benchmark,
           "bf16_fwd_bwd_device_ops": census,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del disc, params, p16, audio, a16, bf16_leaves
    torch.cuda.empty_cache()
    return out


def packed_vs_native_step(out_dir: str) -> dict:
    """One f32 fused GAN step (TF32 off) of the flagship on the
    FLAGSHIP_TRAINING recipe at the (128, 512) bucket, batch 8, 8192-sample
    segments, dropout 0, constant lr, with the packed lowering and with the
    native one from the same weights and batch, and the native step in f64
    as the generator's reference (``PACKED_VS_NATIVE``). Eager
    (``disable_graphs()``): the gradients are recorded inside the step."""
    from m2tts_tpu_torch.data.dataset import make_batches
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, FLAGSHIP_TRAINING
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    extra = {"model.text_encoder.dropout": 0.0, "training.bf16": False,
             "training.batch_size": 8, "training.lr_scheduler": "constant",
             "training.warmup_steps": 0}
    tr = {}
    for run, low in (("native", "native"), ("packed", "packed"),
                     ("f64", "native")):
        tr[run] = Stage2Trainer(train_config(
            FLAGSHIP_MODEL, FLAGSHIP_TRAINING, f"{out_dir}/step_{run}",
            overrides=PACKED_OVERRIDES,
            **{**extra, "training.disc_lowering": low}), device="cuda")
        if tr[run].disc_lowering != low:
            raise RuntimeError(f"{run}: disc_lowering {tr[run].disc_lowering}")
    for run in ("packed", "f64"):
        t = tr[run]
        t.model.load_state_dict(tr["native"].model.state_dict())
        t.discriminator.load_state_dict(
            tr["native"].discriminator.state_dict())
        if run == "f64":
            t.model.double()
            t.discriminator.double()
    grads = {}
    for run, t in tr.items():  # record each update's gradients
        for net in ("d", "g"):
            def update(g, *args, _fn=getattr(t, f"_{net}_update"),
                       _key=(run, net)):
                grads[_key] = [x.detach().double() for x in g]
                return _fn(g, *args)

            setattr(t, f"_{net}_update", update)
    native = tr["native"]
    frames = native.buckets[1][1]  # the (128, 512) bucket
    host = next(b for b in make_batches(
        native.dataset, 8, native.buckets, seed=0,
        audio_samples=native._max_audio_samples())
        if b["mel"].shape[1] == frames)
    host = native._prepare(host, np.random.default_rng(SEED))
    batches = {"native": host, "packed": host, "f64": {
        k: v.astype(np.float64) if getattr(v, "dtype", None) == np.float32
        else v for k, v in host.items()}}
    with disable_graphs():
        losses = {run: {k: v.item() for k, v in tr[run].train_step(
            dict(batches[run])).items()} for run in tr}

    def dist(a, b):  # relative L2 distance of gradient list a from b
        num = math.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b)))
        return num / math.sqrt(sum(float((y ** 2).sum()) for y in b))

    bars = PACKED_VS_NATIVE
    out = {"losses": losses,
           "loss_rel": {k: abs(losses["packed"][k] - v) / max(abs(v), 1e-30)
                        for k, v in losses["native"].items()},
           "d_grad_rel_l2": dist(grads[("packed", "d")],
                                 grads[("native", "d")]),
           "g_grad_rel_l2": dist(grads[("packed", "g")],
                                 grads[("native", "g")]),
           "g_grad_rel_l2_f64": {run: dist(grads[(run, "g")],
                                           grads[("f64", "g")])
                                 for run in ("native", "packed")}}
    radius = (bars["g_vs_f64"] * out["g_grad_rel_l2_f64"]["native"]
              + bars["g_floor"])
    out["g_bar"] = radius
    if (max(out["loss_rel"].values()) > bars["loss_rel"]
            or out["d_grad_rel_l2"] > bars["d_grad_rel_l2"]
            or out["g_grad_rel_l2_f64"]["packed"] > radius):
        raise RuntimeError(f"packed GAN step vs native: {out}")
    for t in tr.values():
        t.close()
    return out


class PackedRouteCounts:
    """While entered, counts the trainer's calls of
    ``packed_multiscale_apply`` (``applies``) and, inside the packed
    lowering, its strided convs by route: ``packed``, or ``plain_strided``
    (a length the stride does not divide, as in JAX). The functions are
    wrapped here and restored on exit; the model keeps no counter."""

    def __init__(self):
        from m2tts_tpu_torch.models import discriminator as tdisc
        from m2tts_tpu_torch.training import trainer_stage2 as tstage2

        self.counts = {"applies": 0, "packed": 0, "plain_strided": 0}
        self._slots = ((tstage2, "packed_multiscale_apply", "applies"),
                       (tdisc, "_packed_strided_conv", "packed"),
                       (tdisc, "_plain_conv", "plain_strided"))
        self._saved = []

    def __enter__(self) -> dict:
        for mod, name, key in self._slots:
            fn = getattr(mod, name)

            def counted(*args, _fn=fn, _key=key, **kw):
                # _plain_conv(x, w, b, stride, groups): strided calls only
                if _key != "plain_strided" or args[3] > 1:
                    self.counts[_key] += 1
                return _fn(*args, **kw)

            self._saved.append((mod, name, fn))
            setattr(mod, name, counted)
        return self.counts

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()


def train_stage2_packed_phase(out_dir: str, card: str, stage1_dir,
                              buckets: dict, counters: Counters) -> dict:
    """Flagship GAN steps on FLAGSHIP_TRAINING (batch 32, bf16, 8192-sample
    segments, no spectral norm) with ``disc_lowering: packed`` and the same
    steps with ``native``, each warm-started from the stage-1 checkpoint;
    the packed run must go through ``packed_multiscale_apply``
    (``PackedRouteCounts``) with no strided conv left plain. The steps
    are CUDA graph replays (a bucket's first step runs eagerly and
    captures: the only steps that call the Python apply). Then ms per
    fused step by bucket in turns, as graph replays and eagerly
    (``disable_graphs()``), a 3-step profile at (128, 512) for each both
    ways (device operations by kind, busy share), one f32 step held
    packed against native (``packed_vs_native_step``), and the packed
    run's checkpoint served through ``from_checkpoint`` (``auto``:
    ``vocoder_tc.cu``) at 0 LSB against its in-memory weights."""
    from m2tts_tpu_torch.models.tts_model import build_model
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, FLAGSHIP_TRAINING

    t0 = time.perf_counter()
    steps = PACKED_OVERRIDES["training.max_steps"]
    runs, trainers = {}, {}
    for low in ("native", "packed"):
        cfg = train_config(FLAGSHIP_MODEL, FLAGSHIP_TRAINING,
                           f"{out_dir}/{low}", overrides=PACKED_OVERRIDES,
                           **{"training.disc_lowering": low,
                              "training.init_generator_from": str(stage1_dir)})
        t = Stage2Trainer(cfg, device="cuda")
        if t.disc_lowering != low or t.discriminator.spectral_norm:
            raise RuntimeError(f"{low}: lowering {t.disc_lowering}, spectral "
                               f"norm {t.discriminator.spectral_norm}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with PackedRouteCounts() as counts:
            t1 = time.perf_counter()
            t.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        if low == "packed":  # the weights its last checkpoint holds
            served_weights = _eval_weights(t)
        # three applies a fused step (D on [real; fake], G's fake, G's
        # real), made by a bucket's first step twice (its eager run and
        # its capture) and by a replay never
        graphs = t._graphs.stats()
        want = ({"applies": 6 * graphs["graphs"], "plain_strided": 0}
                if low == "packed" else {"applies": 0})
        if any(counts[k] != v for k, v in want.items()) \
                or (low == "packed" and counts["packed"] < 1) \
                or graphs["graphs"] + graphs["replays"] != steps \
                or graphs["replays"] < 1:
            raise RuntimeError(f"{low} run: packed apply counts {counts}, "
                               f"graphs {graphs}")
        rows = _read_metrics(cfg.get("paths.log_dir"))
        logged = {int(r["step"]): {k: float(v) for k, v in r.items()
                                   if v and _is_loss(k)}
                  for r in rows if r.get("total_loss")}
        values = [v for ls in logged.values() for v in ls.values()]
        if len(logged) != steps // PACKED_OVERRIDES["training.log_every"] \
                or not values or not all(map(math.isfinite, values)):
            raise RuntimeError(f"{low} run: losses {logged}")
        runs[low] = {"wall_s": wall, "steps_per_s": steps / wall,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "packed_apply_counts": counts, "graphs": graphs,
                     "losses_logged": logged}
        trainers[low] = t
    rng = np.random.default_rng(SEED)
    ref = trainers["native"]
    batches = bucket_batches(
        ref, lambda b: ref._transfer.transfer(ref._prepare(b, rng)),
        ref._max_audio_samples())
    for mode in ("graph", "eager"):
        with graph_mode(mode):
            for low in ("native", "packed", "packed", "native"):
                for (tb, fb), b in batches.items():
                    runs[low].setdefault("ms_per_step_by_bucket", {}) \
                        .setdefault(mode, {}).setdefault(
                            f"{tb},{fb}", []).append(step_ms(
                                trainers[low].train_step, b, iters=5))
    b512 = batches[tuple(ref.buckets[1])]
    for low in ("native", "packed"):
        for mode in ("graph", "eager"):
            with graph_mode(mode):
                runs[low].setdefault("profile_3_steps_128_512", {})[mode] = \
                    profile_batch(lambda: [trainers[low].train_step(b512)
                                           for _ in range(3)], card,
                                  phase=f"train_stage2_packed_profile_{low}"
                                        f"_{mode}")
    del batches, b512
    out = {"phase": "train_stage2_packed", "card": card,
           "overrides": PACKED_OVERRIDES,
           "batch_size": ref.batch_size, "bf16": ref.bf16,
           "segment_samples": ref.seg_frames * ref.upsample,
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "warm_start": str(stage1_dir), **runs}
    out["one_step_f32"] = packed_vs_native_step(out_dir)

    # the packed run's checkpoint, served through the kernel
    packed = trainers["packed"]
    served = pipeline.from_checkpoint(packed.ckpt.directory, device="cuda",
                                      vocoder_backend="auto", **buckets)
    model = build_model(FLAGSHIP_MODEL)
    model.load_state_dict(served_weights)
    in_memory = pipeline.Synthesizer(model, vocoder_backend="auto",
                                     device="cuda", **buckets)
    ids, lengths = packed_eval_texts(served)
    scale = calibrate_scale(served, ids, lengths)
    counters.zero()
    got = served.synthesize_batch(EVAL_TEXTS, duration_scale=scale)
    launches = counters.read()
    if launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"train_stage2_packed skipped the kernel: "
                           f"{launches}")
    want = in_memory.synthesize_batch(EVAL_TEXTS, duration_scale=scale)
    for i, (a, b) in enumerate(zip(got, want)):
        if not a["frames"] == b["frames"] > 0 or a.get("truncated"):
            raise RuntimeError(f"text {i}: frames {a['frames']} vs "
                               f"{b['frames']}")
        pcm_diff(a["audio_pcm"], b["audio_pcm"], (0, None),
                 f"packed stage-2 checkpoint vs in-memory, text {i}")
    out.update(launches=launches, served_frames=[r["frames"] for r in got],
               served_max_pcm_lsb_vs_in_memory=0,
               seconds=time.perf_counter() - t0)
    emit(out)
    for t in trainers.values():
        t.close()
    torch.cuda.empty_cache()
    return out


# graph replay against disable_graphs() eager for the training graphs
# (train_stage2_graphs), under deterministic algorithms where they exist:
# bitwise; an op without a deterministic CUDA version (named by its
# warning) is listed, and its configuration held to GRAPH_NONDET, relative
# to each tensor's largest value, instead
GRAPH_NONDET = 1e-5
# the steps of each held configuration: a bucket's first (eager, then the
# capture) and one replay
S2_GRAPH_STEPS = 2


@contextlib.contextmanager
def deterministic_ops():
    """Deterministic algorithms where they exist (``warn_only``); yields a
    list that is filled, at exit, with the ops that warned that they have
    no deterministic version."""
    import warnings

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    nondet: list = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield nondet
        finally:
            torch.use_deterministic_algorithms(False)
            nondet.extend(sorted({
                str(w.message).split(" does not have")[0][:120]
                for w in caught if "deterministic" in str(w.message)}))


def _max_rel(got: dict, want: dict) -> float:
    """The largest difference of two dicts of tensors, each relative to
    the largest value of its tensor in ``want``."""
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        worst = max(worst, float((g - w).abs().max()
                                 / w.abs().max().clamp_min(1e-30)))
    return worst


def _s2_state(t) -> dict:
    """A stage-2 trainer's gathered weights, EMA and Adam moments, on the
    host (``_host_state``)."""
    st = t._host_state()
    out = {f"g.{k}": v for k, v in st["generator"].items()}
    out.update({f"d.{k}": v for k, v in st["discriminator"].items()})
    out.update({f"ema.{k}": v
                for k, v in st.get("generator_ema", {}).items()})
    for net in ("g", "d"):
        for m in ("mu", "nu"):
            out.update({f"{net}.{m}.{k}": v
                        for k, v in st[f"{net}_opt_state"][m].items()})
    return out


def _held_pair(pair: dict, batches: list, step, state, what: str) -> dict:
    """Each of ``batches`` through ``step(trainer, batch)`` (metrics) on
    ``pair["eager"]`` under ``disable_graphs()`` and on ``pair["graph"]``,
    deterministic algorithms on; then ``state(trainer)`` of both. Bitwise,
    or within GRAPH_NONDET where an op has no deterministic version."""
    with deterministic_ops() as nondet:
        losses = 0.0
        for b in batches:
            with graph_mode("eager"):
                me = step(pair["eager"], b)
            mg = step(pair["graph"], b)
            if set(me) != set(mg):
                raise RuntimeError(f"{what}: metrics {set(me)} vs {set(mg)}")
            losses = max(losses, _max_rel(mg, me))
        states = _max_rel(state(pair["graph"]), state(pair["eager"]))
    bitwise = losses == 0.0 and states == 0.0
    if (not bitwise and not nondet) or max(losses, states) > GRAPH_NONDET:
        raise RuntimeError(f"{what}: graph vs eager losses {losses}, state "
                           f"{states}; ops without a deterministic version: "
                           f"{nondet}")
    return {"steps": len(batches), "loss_max_rel": losses,
            "state_max_rel": states, "bitwise": bitwise,
            "nondeterministic_ops": nondet}


def _s2_batches(t, cached: bool, rng_seed: int = SEED) -> dict:
    """One device batch of each bucket: host segments, or (``cached``) the
    whole waveforms a device-cached step windows."""
    from m2tts_tpu_torch.training.trainer import _rows

    rng = np.random.default_rng(rng_seed)
    if cached:
        def put(b):
            return t._transfer.transfer(dict(
                b, audio=t._stage_audio(b["audio"], b["mel"].shape[1])))
    else:
        def put(b):  # this rank's rows on a mesh
            return t._transfer.transfer(_rows(t._prepare(b, rng), t.mesh))
    return bucket_batches(t, put, t._max_audio_samples())


def _turns(step, batches: dict, iters: int = 5, warmup: int = 2) -> dict:
    """ms a ``step(batch)`` by bucket in turns: graph, eager, eager,
    graph."""
    ms: dict = {}
    for mode in ("graph", "eager", "eager", "graph"):
        with graph_mode(mode):
            for (tb, fb), b in batches.items():
                ms.setdefault(mode, {}).setdefault(f"{tb},{fb}", []).append(
                    step_ms(step, b, iters=iters, warmup=warmup))
    return ms


def _timed_both_ways(step, batches: dict, b512, card: str, phase: str,
                     iters: int = 5) -> dict:
    """ms a ``step(batch)`` by bucket in turns (graph, eager, eager,
    graph), and 3 steps at ``b512`` profiled both ways."""
    ms = _turns(step, batches, iters)
    prof = {}
    for mode in ("graph", "eager"):
        with graph_mode(mode):
            prof[mode] = _profile_figures(lambda: [step(b512)
                                                   for _ in range(3)],
                                          card, f"{phase}_{mode}")
    return {"ms_per_step_by_bucket": ms, "profile_3_steps_128_512": prof}


def train_stage2_graphs_phase(out_dir: str, card: str, stage1_dir,
                              packed: dict) -> dict:
    """The stage-2 step, validation's forward and stage 1 under
    accumulation as CUDA graphs at the flagship's widths, each warm-started
    from the stage-1 checkpoint:

    - held against ``disable_graphs()`` eager (``_held_pair``): the recipe
      (STAGE2_TRAINING: bf16, 32768-sample segments, spectral norm, EMA)
      fused on host batches, ``S2_GRAPH_STEPS`` steps a bucket; the packed
      lowering (FLAGSHIP_TRAINING) with ``alternate_gd`` and k = 2, eight
      steps at (128, 512) (a graph per net and branch, each replayed);
      the native lowering on
      the device cache; validation's forward of the recipe's EMA after
      its steps and after the state before them is loaded back; stage 1 in
      f32 at k = 2 (four micro-steps a bucket) and its eval step;
    - timed, graph against eager (``_timed_both_ways``): ms a GAN step of
      the recipe by bucket, 3 steps at (128, 512) profiled (wall, busy
      share, device operations), beside the packed and native figures of
      ``train_stage2_packed``; peak memory; ms of validation's forward at
      (128, 512); stage 1 in bf16 at k = 2, ms a micro-step and an eval
      step by bucket."""
    from m2tts_tpu_torch.training.trainer import Stage1Trainer
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING,
                                              STAGE2_TRAINING)

    t_phase = time.perf_counter()
    warm = {"training.init_generator_from": str(stage1_dir),
            "training.validate_quality": False}
    out = {"phase": "train_stage2_graphs", "card": card,
           "tol": {"nondeterministic_rel": GRAPH_NONDET}}

    def s2_step(t, b):
        return t.train_step(dict(b))

    def pair(training, name, **extra):
        return {mode: Stage2Trainer(train_config(
            FLAGSHIP_MODEL, training, f"{out_dir}/{name}_{mode}",
            overrides=STAGE2_OVERRIDES, **warm, **extra), device="cuda")
            for mode in ("eager", "graph")}

    # ---- held: the recipe, fused, host batches; then validation's forward
    held = {}
    tr = pair(STAGE2_TRAINING, "recipe")
    before = tr["graph"]._host_state()  # a host copy
    bb = _s2_batches(tr["eager"], cached=False)
    held["recipe_fused"] = _held_pair(
        tr, [b for b in bb.values() for _ in range(S2_GRAPH_STEPS)],
        s2_step, _s2_state, "recipe fused step")
    held["recipe_fused"]["graphs"] = tr["graph"]._graphs.stats()
    b512 = bb[tuple(tr["graph"].buckets[1])]

    def val_step(t, b):
        mel_loss, spec_loss, mel, audio = t._val_fwd(b, t._eval_params())
        return {"mel_loss": mel_loss, "spectral_loss": spec_loss,
                "mel": mel, "audio": audio}

    held["validation_after_steps"] = _held_pair(
        tr, list(bb.values()), val_step, lambda t: {}, "validation forward")
    g = tr["graph"]
    g._load_state(before, before.get("generator_ema"))
    tr["eager"]._load_state(before, before.get("generator_ema"))
    held["validation_after_restore"] = _held_pair(
        tr, list(bb.values()), val_step, lambda t: {},
        "validation forward after a restore")
    restored = val_step(g, b512)["audio"]
    with graph_mode("eager"):
        again = val_step(g, b512)["audio"]
    if not torch.equal(restored, again):
        raise RuntimeError("validation after a restore is not the restored "
                           "weights' audio")
    del tr, g, bb, b512, before
    gc.collect()  # the trainers' graphs and pools
    torch.cuda.empty_cache()

    # ---- held: packed, alternating, k = 2; native on the device cache
    tr = pair(FLAGSHIP_TRAINING, "packed_alt_k2",
              **{"training.disc_lowering": "packed",
                 "training.alternate_gd": True,
                 "training.gradient_accumulation_steps": 2})
    bb = _s2_batches(tr["eager"], cached=False)
    held["packed_alternate_k2"] = _held_pair(  # 4 graphs, each replayed
        tr, [bb[tuple(tr["eager"].buckets[1])]] * 8, s2_step, _s2_state,
        "packed alternate_gd k=2")
    held["packed_alternate_k2"]["graphs"] = tr["graph"]._graphs.stats()
    del tr, bb
    tr = pair(FLAGSHIP_TRAINING, "native_cached",
              **{"training.disc_lowering": "native",
                 "training.device_data_cache": True})
    bb = _s2_batches(tr["eager"], cached=True)
    held["native_device_cached"] = _held_pair(
        tr, [b for b in bb.values() for _ in range(S2_GRAPH_STEPS)],
        s2_step, _s2_state, "native device-cached step")
    del tr, bb
    gc.collect()
    torch.cuda.empty_cache()

    # ---- held: stage 1 at k = 2, f32, and its eval step
    s1 = {mode: Stage1Trainer(train_config(
        FLAGSHIP_MODEL, FLAGSHIP_TRAINING, f"{out_dir}/s1_{mode}",
        overrides=GRAPH_TRAIN,
        **{"training.gradient_accumulation_steps": 2}), device="cuda")
        for mode in ("eager", "graph")}
    init = s1["graph"]._host_state_copy()
    sb = bucket_batches(s1["eager"], s1["eager"]._put)

    def s1_step(t, b):
        losses = t._guarded_step(b)
        t.step += 1
        return losses

    held["stage1_k2"] = _held_pair(
        s1, [b for b in sb.values() for _ in range(4)], s1_step,
        lambda t: dict(t.model.state_dict()), "stage-1 k=2 step")
    held["stage1_k2"]["graphs"] = s1["graph"]._graphs.stats()
    held["stage1_eval"] = _held_pair(
        s1, list(sb.values()), lambda t, b: t._eval_step(b), lambda t: {},
        "stage-1 eval step")
    for t in s1.values():
        t._restore(init, 0)
    held["stage1_eval_after_restore"] = _held_pair(
        s1, list(sb.values()), lambda t, b: t._eval_step(b), lambda t: {},
        "stage-1 eval step after a restore")
    out["held"] = held
    del s1, sb, init
    gc.collect()
    torch.cuda.empty_cache()

    # ---- timed: the recipe; packed and native from train_stage2_packed
    torch.cuda.reset_peak_memory_stats()
    t = Stage2Trainer(train_config(
        FLAGSHIP_MODEL, STAGE2_TRAINING, f"{out_dir}/recipe_timed",
        overrides=STAGE2_OVERRIDES, **warm), device="cuda")
    bb = _s2_batches(t, cached=False)
    b512 = bb[tuple(t.buckets[1])]
    first = []  # a bucket's first call (eager, then the capture), replays
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_step(b512)
        torch.cuda.synchronize()
        first.append((time.perf_counter() - t0) * 1e3)
    timed = {"recipe_spectral_norm": _timed_both_ways(
        t.train_step, bb, b512, card, "train_stage2_graphs_recipe")}
    timed["recipe_spectral_norm"]["first_calls_128_512_ms"] = first
    timed["recipe_spectral_norm"]["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    timed["recipe_spectral_norm"]["graphs"] = t._graphs.stats()
    params = t._eval_params()
    val = {}
    for mode in ("graph", "eager", "eager", "graph"):
        with graph_mode(mode):
            val.setdefault(mode, []).append(step_ms(
                lambda b: t._val_fwd(b, params), b512, iters=5))
    timed["validation_forward_128_512_ms"] = val
    for low in ("packed", "native"):
        timed[f"{low}_bf16"] = {
            k: packed[low][k] for k in ("ms_per_step_by_bucket",
                                        "profile_3_steps_128_512",
                                        "max_memory_allocated_gb", "graphs")}
    t.close()
    del t, bb, b512, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- timed: stage 1 in bf16 at k = 2, micro-steps and eval steps
    s1 = Stage1Trainer(train_config(
        FLAGSHIP_MODEL, FLAGSHIP_TRAINING, f"{out_dir}/s1_timed",
        **{"training.gradient_accumulation_steps": 2}), device="cuda")
    sb = bucket_batches(s1, s1._put)
    s1_ms = {}
    for mode in ("graph", "eager", "eager", "graph"):
        with graph_mode(mode):
            for (tb, fb), b in sb.items():
                s1_ms.setdefault("micro_step", {}).setdefault(
                    mode, {}).setdefault(f"{tb},{fb}", []).append(
                    step_ms(s1._train_step, b))
                s1_ms.setdefault("eval_step", {}).setdefault(
                    mode, {}).setdefault(f"{tb},{fb}", []).append(
                    step_ms(s1._eval_step, b))
    s1_ms["graphs"] = s1._graphs.stats()
    timed["stage1_bf16_k2"] = s1_ms
    s1.close()
    del s1, sb
    torch.cuda.empty_cache()
    out["timed"] = timed
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def pipeline_smoke_phase(card: str, counters: Counters) -> dict:
    """``python -m m2tts_tpu_torch.smoke`` in this process, on the card:
    all seven parts, exit 0; the vocoder launches of its inference part."""
    import contextlib
    import io

    from m2tts_tpu_torch import smoke

    t0 = time.perf_counter()
    buf = io.StringIO()
    counters.zero()
    with contextlib.redirect_stdout(buf):
        rc = smoke.main([])
    launches = counters.read()
    text = buf.getvalue()
    if rc != 0 or "7/7 parts passed" not in text \
            or launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"smoke suite: rc {rc}, launches {launches}\n"
                           f"{text}")
    out = {"phase": "pipeline_smoke", "card": card, "rc": rc,
           "summary": text.strip().splitlines()[-1], "launches": launches,
           "lines": [l for l in text.splitlines() if l.startswith("    ")],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def run_cli(main_fn, argv) -> str:
    """``main_fn(argv)`` in this process (it must return 0); its stdout."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    if rc != 0:
        raise RuntimeError(f"{argv[:2]} returned {rc}")
    return buf.getvalue()


def read_wav(path) -> np.ndarray:
    import wave

    with wave.open(str(path), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def as_written(audio: np.ndarray, path) -> np.ndarray:
    """``audio`` through ``save_wav``, as the CLIs write it, read back."""
    from m2tts_tpu_torch.frontend.audio import save_wav

    save_wav(audio, path)
    return read_wav(path)


# the synthesize CLI's texts: the longest eval text at ~200 frames, so the
# long-form line's ~250-phoneme chunks stay inside the default 1024-frame
# bucket
CLI_FRAME_TARGET = 200
LONG_TEXT = " ".join(EVAL_TEXTS * 2)


def synthesize_cli_phase(ckdir, out_dir: str, card: str,
                         counters: Counters) -> dict:
    """``serving.synthesize.main(argv)`` in this process on the stage-2
    checkpoint (its EMA), at the CLI's defaults (``auto``: bf16 on
    ``vocoder_tc.cu``): ``--text``, a ``--batch-file`` of 8 lines, one of
    them over the phoneme budget (the long-form path), each WAV equal at
    0 LSB to the in-process Synthesizer's audio written the same way;
    ``--griffin-lim``, equal at 0 LSB to ``AudioProcessor.mel_to_audio``
    of the in-process mel; ``--streaming --compute-dtype f32``
    (``vocoder_tc32.cu``), held as phase 5 holds a stream: against its own
    mel vocoded whole by the kernel (F32_TOL, plus the quantiser's 1 LSB).
    The streamed WAV is not the batch path's: the decoder attends over the
    padding frames of its frame bucket (1000 frames for a stream, the
    bucket for a batch), in the JAX package as here."""
    from m2tts_tpu_torch.frontend.audio import AudioProcessor
    from m2tts_tpu_torch.ops.cuda.vocoder import fused_vocoder_forward
    from m2tts_tpu_torch.ops.vocoder_mm import pack_vocoder_weights
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.serving import synthesize as cli
    from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer

    t_phase = time.perf_counter()
    ref = pipeline.from_checkpoint(ckdir, device="cuda")
    if (ref.vocoder_backend, ref.compute_dtype) != ("cuda", "bf16"):
        raise RuntimeError(f"auto resolved to {ref.vocoder_backend}/"
                           f"{ref.compute_dtype}")
    ids, lengths = packed_eval_texts(ref)
    scale = calibrate_scale(ref, ids, lengths, CLI_FRAME_TARGET)
    base = ["--checkpoint", str(ckdir), "--duration-scale", repr(scale)]
    lines = EVAL_TEXTS[:4] + [LONG_TEXT] + EVAL_TEXTS[4:7]
    budget = ref.phoneme_budget() - 2
    n_phon = [len(ref.text_processor.text_to_phonemes(t)) for t in lines]
    if sum(n > budget for n in n_phon) != 1:
        raise RuntimeError(f"batch file phonemes {n_phon}, budget {budget}")
    bfile = os.path.join(out_dir, "lines.txt")
    with open(bfile, "w") as f:
        f.write("\n".join(lines) + "\n")
    runs, out = {}, {"phase": "synthesize_cli", "card": card,
                     "duration_scale": scale}
    counters.zero()
    for name, args in (
            ("text", ["--text", EVAL_TEXTS[0]]),
            ("batch_file", ["--batch-file", bfile]),
            ("griffin_lim", ["--text", EVAL_TEXTS[1], "--griffin-lim"]),
            ("streaming", ["--text", EVAL_TEXTS[4], "--streaming",
                           "--compute-dtype", "f32"])):
        wav = os.path.join(out_dir, f"{name}.wav")
        t0 = time.perf_counter()
        log = run_cli(cli.main, base + args + ["--output", wav])
        runs[name] = {"seconds": time.perf_counter() - t0, "log": log}
    launches = counters.read()
    if launches["fused_vocoder_tc"] < 1 or launches["fused_vocoder_tc32"] < 1:
        raise RuntimeError(f"synthesize_cli skipped a kernel: {launches}")
    out["launches"] = launches

    # --text and --batch-file against the in-process Synthesizer, 0 LSB
    want = {"text": ref.synthesize_batch([EVAL_TEXTS[0]], scale)}
    want["batch_file"] = ref.synthesize_batch_long(lines, scale)
    if "long-form: 1/8 text(s)" not in runs["batch_file"]["log"]:
        raise RuntimeError("the batch file did not take the long-form path")
    for name, results in want.items():
        wavs = ([os.path.join(out_dir, "text.wav")] if name == "text" else
                [os.path.join(out_dir, f"batch_file_{i:03d}.wav")
                 for i in range(len(lines))])
        diffs = []
        for i, (r, w) in enumerate(zip(results, wavs)):
            if r.get("truncated") or r["frames"] <= 0:
                raise RuntimeError(f"{name} {i}: frames {r['frames']} "
                                   f"truncated {r.get('truncated')}")
            diffs.append(pcm_diff(read_wav(w), as_written(
                r["audio"], os.path.join(out_dir, "ref.wav")), (0, None),
                f"synthesize CLI {name} line {i}")["max_pcm_lsb"])
        out[name] = {"max_pcm_lsb": max(diffs),
                     "frames": [int(r["frames"]) for r in results],
                     "seconds": runs[name]["seconds"]}
    out["batch_file"]["long_form_chunks"] = len(want["batch_file"][4]
                                                ["chunks"])
    m = re.search(r"Generated ([\d.]+)s audio in ([\d.]+)s \(RTF ([\d.]+)",
                  runs["batch_file"]["log"])
    out["batch_file"].update(audio_s=float(m.group(1)),
                             synth_s=float(m.group(2)), rtf=float(m.group(3)))

    # --griffin-lim against the in-process mel inverted on the host
    mel = ref.synthesize(EVAL_TEXTS[1], scale, want_mel=True)["mel"]
    gl = AudioProcessor(n_mels=mel.shape[-1]).mel_to_audio(mel.T)
    out["griffin_lim"] = {
        **pcm_diff(read_wav(os.path.join(out_dir, "griffin_lim.wav")),
                   as_written(gl, os.path.join(out_dir, "ref.wav")),
                   (0, None), "synthesize CLI --griffin-lim"),
        "frames": int(mel.shape[0]), "seconds": runs["griffin_lim"]["seconds"]}

    # --streaming (f32) against its mel vocoded whole by the f32 kernel
    ss = StreamingSynthesizer(ref.model, compute_dtype="f32", device="cuda")
    enc = ss.text_processor.batch([EVAL_TEXTS[4]], ss.text_bucket)
    with torch.inference_mode():
        smel, total = ss._acoustic(torch.from_numpy(enc["phoneme_ids"]).cuda(),
                                   torch.from_numpy(enc["lengths"]).cuda(),
                                   scale)
        frames = min(int(total[0]), ss.max_frames)
        whole = fused_vocoder_forward(
            smel[:, :frames].contiguous(),
            pack_vocoder_weights(ref.model.vocoder, "f32"),
            ref.model.upsample_rates, "f32")[0].cpu().numpy()
    got = read_wav(os.path.join(out_dir, "streaming.wav"))
    want_pcm = as_written(whole, os.path.join(out_dir, "ref.wav"))
    bar = int(F32_TOL["atol"] * 32767 + F32_TOL["rtol"] * 32767) + 1
    m1 = re.search(r"first-chunk latency ([\d.]+) ms", runs["streaming"]["log"])
    m2 = re.search(r"total ([\d.]+)s \(RTF ([\d.]+)\)",
                   runs["streaming"]["log"])
    out["streaming"] = {
        **pcm_diff(got, want_pcm, (bar, None),
                   "synthesize CLI --streaming vs its mel vocoded whole"),
        "max_pcm_lsb_bar": bar, "frames": frames,
        "chunks": -(-frames // ss.vocoder.chunk_frames),
        "first_chunk_ms": float(m1.group(1)),
        "stream_s": float(m2.group(1)), "rtf": float(m2.group(2)),
        "seconds": runs["streaming"]["seconds"]}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


EXPORT_BUCKETS = {"text_buckets": (32, 64, 128),
                  "frame_buckets": (128, 256, 512), "batch_buckets": (1, 8)}


def export_phase(synth, scale: float, out_dir: str, card: str,
                 counters: Counters, lsb_bar) -> dict:
    """``export_synthesizer`` of the flagship (``full=False``: 3 text × 3
    frame buckets, 9 graphs and 3 probes) on the card in bf16 and f32, for
    ``cuda`` and ``cpu``; ``ExportedSynthesizer`` on the card against the
    live ``torch``-backend Synthesizer (frames equal, ±1 LSB) and against
    the ``auto`` (kernel) Synthesizer (the dtype's ``lsb_bar``); the same
    artifact loaded on the CPU against a CPU Synthesizer of the same
    weights (±1 LSB) on a short text; export seconds, artifact MB, and
    warm ms per call of the exported graph beside the live calls."""
    import copy

    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.serving.export import (ExportedSynthesizer,
                                                export_synthesizer)

    t_phase = time.perf_counter()
    texts = EVAL_TEXTS[::2]
    cpu_model = copy.deepcopy(synth.model).cpu()
    out = {"phase": "export", "card": card, "duration_scale": scale,
           "buckets": EXPORT_BUCKETS}
    counters.zero()
    for cd in ("bf16", "f32"):
        live = pipeline.Synthesizer(synth.model, compute_dtype=cd,
                                    vocoder_backend="torch", device="cuda",
                                    **EXPORT_BUCKETS)
        auto = pipeline.Synthesizer(synth.model, compute_dtype=cd,
                                    vocoder_backend="auto", device="cuda",
                                    **EXPORT_BUCKETS)
        art = os.path.join(out_dir, f"artifact_{cd}")
        t0 = time.perf_counter()
        manifest = export_synthesizer(live, art, platforms=("cuda", "cpu"))
        export_s = time.perf_counter() - t0
        if (len(manifest["graphs"]), len(manifest["probes"])) != (9, 3):
            raise RuntimeError(f"{len(manifest['graphs'])} graphs, "
                               f"{len(manifest['probes'])} probes")
        mb = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(art) for f in fs) / 1e6
        ex = ExportedSynthesizer(art, device="cuda")
        vs_live, vs_auto, frames = [], [], []
        for text in texts:
            e, lv, au = (s.synthesize(text, scale) for s in (ex, live, auto))
            if not e["frames"] == lv["frames"] == au["frames"] > 0:
                raise RuntimeError(f"{cd} exported frames {e['frames']} vs "
                                   f"live {lv['frames']} / auto "
                                   f"{au['frames']}")
            frames.append(e["frames"])
            vs_live.append(pcm_diff(e["audio_pcm"], lv["audio_pcm"], (1, None),
                                    f"{cd} exported vs live torch")
                           ["max_pcm_lsb"])
            vs_auto.append(pcm_diff(e["audio_pcm"], au["audio_pcm"],
                                    lsb_bar[cd], f"{cd} exported vs auto")
                           ["max_pcm_lsb"])
        # warm ms a call (host clock; each call ends in its PCM's copy to
        # the host), batch 1, the longest of the texts
        timing = {}
        for name, s in (("exported", ex), ("live_torch", live),
                        ("live_auto", auto)):
            s.synthesize(texts[0], scale)
            t0 = time.perf_counter()
            for _ in range(10):
                s.synthesize(texts[0], scale)
            timing[f"{name}_ms"] = (time.perf_counter() - t0) / 10 * 1e3
        short = "Hello world."
        ex_cpu = ExportedSynthesizer(art, device="cpu")
        live_cpu = pipeline.Synthesizer(cpu_model, compute_dtype=cd,
                                        vocoder_backend="torch",
                                        device="cpu", **EXPORT_BUCKETS)
        t0 = time.perf_counter()
        c = ex_cpu.synthesize(short, scale)
        cpu_s = time.perf_counter() - t0
        lc = live_cpu.synthesize(short, scale)
        if not c["frames"] == lc["frames"] > 0:
            raise RuntimeError(f"{cd} CPU-loaded frames {c['frames']} vs "
                               f"{lc['frames']}")
        out[cd] = {"export_s": export_s, "artifact_mb": mb,
                   "graphs": len(manifest["graphs"]),
                   "probes": len(manifest["probes"]),
                   "frames": frames, "max_pcm_lsb_vs_live_torch": max(vs_live),
                   "max_pcm_lsb_vs_auto": max(vs_auto),
                   "auto_bar": lsb_bar[cd][0], **timing,
                   "cpu": {"frames": c["frames"], "first_call_s": cpu_s,
                           **pcm_diff(c["audio_pcm"], lc["audio_pcm"],
                                      (1, None), f"{cd} artifact on the CPU "
                                      "vs a CPU Synthesizer")}}
    launches = counters.read()
    if launches["fused_vocoder_tc"] < 1 or launches["fused_vocoder_tc32"] < 1:
        raise RuntimeError(f"export's auto comparison skipped a kernel: "
                           f"{launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def write_corpus(root: str, n: int = 16, sample_rate: int = 22050) -> list:
    """An LJSpeech-layout corpus (``wavs/`` + ``metadata.csv``) of ``n``
    clips, 1.0–2.5 s of formant-like harmonics under an envelope with a
    little noise, made from SEED; returns the clips."""
    from m2tts_tpu_torch.frontend.audio import save_wav

    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    rng = np.random.default_rng(SEED)
    clips, lines = [], []
    for i in range(n):
        t = np.arange(int(sample_rate * (1.0 + 1.5 * i / (n - 1)))) \
            / sample_rate
        f0 = 110.0 + 15.0 * i + 10.0 * np.sin(2 * np.pi * 3.0 * t)
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        audio = sum(np.sin(k * phase) / k for k in range(1, 8))
        audio *= 0.5 * (1 - np.cos(2 * np.pi * t / t[-1])) \
            * (0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t))
        audio += 0.01 * rng.standard_normal(len(t))
        audio = (0.8 * audio / np.abs(audio).max()).astype(np.float32)
        save_wav(audio, os.path.join(root, "wavs", f"LJ001-{i:04d}.wav"),
                 sample_rate)
        text = EVAL_TEXTS[i % len(EVAL_TEXTS)]
        lines.append(f"LJ001-{i:04d}|{text}|{text}")
        clips.append(audio)
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return clips


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it ("model name", or its
    vendor, family and model numbers where a VM hides the name), with the
    machine type."""
    import platform

    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                     "CPU implementer", "CPU part")
        if fields.get(k)) or "unknown"
    return f"{platform.machine()}: {name}"


def native_frontend_phase(clips, card: str) -> dict:
    """The C++ mel frontend built by the port's loader (``g++ -O3
    -march=native``), held against the NumPy mel on the corpus's clips
    (atol 2e-5); host ms per audio-second of both paths and of the thread
    pool. Host times, on the card machine's CPU."""
    from m2tts_tpu_torch.frontend import native
    from m2tts_tpu_torch.frontend.audio import AudioProcessor

    t0 = time.perf_counter()
    built = not native.lib_path().exists()
    if not native.native_available():
        raise RuntimeError("the native mel frontend did not build")
    build_s = time.perf_counter() - t0
    ap_native = AudioProcessor(n_mels=80, fmax=11025, use_native=True)
    ap_numpy = AudioProcessor(n_mels=80, fmax=11025, use_native=False)
    err = 0.0
    for a in clips:
        d = np.abs(ap_native.compute_mel(a) - ap_numpy.compute_mel(a)).max()
        err = max(err, float(d))
    if err > 2e-5:
        raise RuntimeError(f"native mel differs from NumPy by {err}")
    audio_s = sum(len(a) for a in clips) / 22050
    times = {}
    for name, fn in (
            ("native", lambda: [ap_native.compute_mel(a) for a in clips]),
            ("numpy", lambda: [ap_numpy.compute_mel(a) for a in clips]),
            ("native_batch", lambda: native.compute_mel_batch(
                clips, n_mels=80, fmax=11025.0))):
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        times[f"{name}_host_ms_per_audio_s"] = \
            (time.perf_counter() - t0) / 3 * 1e3 / audio_s
    out = {"phase": "native_frontend", "card": card, "cpu": cpu_model(),
           "cpu_count": os.cpu_count(), "built_now": built,
           "build_s": build_s, "library": native.lib_path().name,
           "clips": len(clips), "audio_s": audio_s,
           "max_abs_err_vs_numpy": err, "tol": 2e-5, **times}
    emit(out)
    return out


def evaluate_cli_phase(stage1_dir, corpus: str, card: str,
                       counters: Counters) -> dict:
    """``evaluation.evaluate.main(argv)`` in this process on the stage-1
    checkpoint: ``--data-dir`` (the corpus, its mels by the native
    frontend: ``AudioProcessor(use_native=True)`` builds and loads it
    first, so the CLI's 'auto' takes it) ``--audio-metrics --json`` and
    two ``-t`` texts (bf16 on ``vocoder_tc.cu``)."""
    from m2tts_tpu_torch.evaluation import evaluate as cli
    from m2tts_tpu_torch.frontend.audio import AudioProcessor

    AudioProcessor(use_native=True)
    t0 = time.perf_counter()
    counters.zero()
    log = run_cli(cli.main, ["--checkpoint", str(stage1_dir), "--data-dir",
                             corpus, "--audio-metrics", "--json",
                             "--num-samples", "16", "-t", EVAL_TEXTS[0],
                             "-t", EVAL_TEXTS[5]])
    launches = counters.read()
    report = json.loads(log.strip().splitlines()[-1])
    ds = report.get("dataset", {})
    need = {"mel_l1_distance", "mel_l2_distance", "mel_combined_distance",
            "duration_l1_loss", "audio_stoi", "audio_spectral_convergence",
            "audio_log_spectral_distance"}
    if not need <= set(ds) or not all(np.isfinite(v) for v in ds.values()):
        raise RuntimeError(f"evaluate report: {report}")
    if len(report.get("texts", [])) != 2 \
            or not 1.0 <= report["estimated_mos_mean"] <= 5.0:
        raise RuntimeError(f"evaluate texts: {report.get('texts')}")
    if launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"evaluate -t skipped the kernel: {launches}")
    out = {"phase": "evaluate_cli", "card": card, "launches": launches,
           "keys": sorted(ds), "dataset": ds,
           "estimated_mos_mean": report["estimated_mos_mean"],
           "text_seconds": [t["seconds"] for t in report["texts"]],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def device_info_phase(card: str) -> dict:
    from m2tts_tpu_torch.utils.device import (clear_caches, get_device_info,
                                              hbm_usage)

    info, usage = get_device_info(), hbm_usage()
    if info["backend"] != "cuda" or len(usage) != torch.cuda.device_count():
        raise RuntimeError(f"device info {info} / {usage}")
    clear_caches()
    out = {"phase": "device_info", "card": card, "info": info,
           "hbm_usage": usage, "hbm_after_clear_caches": hbm_usage()}
    emit(out)
    return out


# ---- multi-device: the mesh paths, each world spawned from here ---------

# stage-1 on a mesh at the flagship's widths, f32 with TF32 off so that the
# layouts differ only in the order of f32 sums; dropout stays on (every
# layout draws the same global masks)
MD_TRAIN = {"training.bf16": False, "training.transfer_dtype": None}
# stage 2 on a (2, 1) mesh: the recipe in f32 at batch 8
MD_STAGE2 = {"training.bf16": False, "training.batch_size": 8}
# the synthesis buckets of a 2-rank data mesh (every batch bucket even)
MD_BUCKETS = {"text_buckets": (32, 64, 128),
              "frame_buckets": (128, 256, 384, 512), "batch_buckets": (8, 64)}
# the mesh steps against the single-device steps: losses as the CPU tests
# hold them (tests/test_torch_parallel.py: rtol 2e-4 / atol 2e-5; at world
# size 1, relative 1e-5, TRAIN_VS_CPU's); the weights after three updates
# within lr/10 (TRAIN_VS_CPU's), not the CPU tests' 1e-6: the card's
# scatter-add atomics (the regulator's gather backward) sum in another
# order from run to run, and Adam's early updates move a weight whose
# gradient is near zero by up to the step's lr times its sign (1.8e-5 at
# world size 1 in one run on an H100); the phase reports the same steps run
# twice without a mesh beside it
MD_LOSS = {"rtol": 2e-4, "atol": 2e-5}
MD_PARAMS_ATOL = TRAIN_VS_CPU["params_abs"]


def _md_device() -> torch.device:
    """This process's card."""
    return torch.device("cuda", torch.cuda.current_device())


def md_stage1(out_dir: str, dev: torch.device, mesh=None) -> dict:
    """Three flagship stage-1 steps (f32) on fixed batches: their losses,
    the gathered weights after them, then ms per step. ``mesh`` None in a
    process group: the mesh ``system.mesh`` gives."""
    from m2tts_tpu_torch.data.dataset import make_batches
    from m2tts_tpu_torch.training.trainer import Stage1Trainer
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = Stage1Trainer(train_config(FLAGSHIP_MODEL, FLAGSHIP_TRAINING, out_dir,
                                   **MD_TRAIN), device=dev, mesh=mesh)
    batches = list(make_batches(t.dataset, t.batch_size, t.buckets,
                                seed=5))[:3]
    losses = [{k: v.item() for k, v in t._train_step(t._put(b)).items()}
              for b in batches]
    params = t._host_state_copy()["params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        t._train_step(t._put(batches[0]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    out = {"losses": losses, "params": params, "ms_per_step": ms,
           "mesh": None if t.mesh is None else list(t.mesh.mesh.shape),
           "batch": [t.batch_size, *batches[0]["mel"].shape[1:]]}
    t.close()
    return out


def md_stage2(out_dir: str, dev: torch.device, mesh=None) -> dict:
    """One fused flagship GAN step (f32, batch 8) on the first seeded host
    batch: its metrics."""
    from m2tts_tpu_torch.data.dataset import data_iterator
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, STAGE2_TRAINING

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = Stage2Trainer(train_config(FLAGSHIP_MODEL, STAGE2_TRAINING, out_dir,
                                   overrides=STAGE2_OVERRIDES, **MD_STAGE2),
                      device=dev, mesh=mesh)
    batch = next(data_iterator(t.dataset, t.batch_size, t.buckets, seed=0,
                               audio_samples=t._max_audio_samples()))
    metrics = {k: v.item() for k, v in t.train_step(batch).items()}
    t.close()
    return metrics


def md_synth(scale: float, texts, dev: torch.device, mesh=None,
             held: bool = False) -> dict:
    """The flagship ``Synthesizer`` (``auto``: the kernels) in bf16 and f32
    on ``texts``: frames and PCM per dtype (graph replays without a mesh
    and on an NCCL mesh), the kernels' launches from the first
    Synthesizer's making on. With ``held``, each dtype's first call (eager,
    then its capture) and a replay held against ``disable_graphs()`` eager
    at 0 LSB, the graphs held, and ms a batch in bf16 as graphs and eagerly
    in turns."""
    from m2tts_tpu_torch.ops.cuda import build, vocoder as cuda_vocoder
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    counters = Counters(build, cuda_vocoder)
    build._AVAILABLE = None  # each new process probes once: count it
    counters.zero()
    out = {}
    for cd in ("bf16", "f32"):
        s = pipeline.from_config(FLAGSHIP_MODEL, seed=SEED, device=dev,
                                 compute_dtype=cd, mesh=mesh, **MD_BUCKETS)
        res = s.synthesize_batch(texts, duration_scale=scale)
        out[cd] = [(r["frames"], r["audio_pcm"]) for r in res]
        if not held:
            continue
        with graph_mode("eager"):
            want = s.synthesize_batch(texts, duration_scale=scale)
        out[f"{cd}_vs_eager"] = {
            "first_call": _held_results(res, want, f"{cd} first call"),
            "replay": _held_results(s.synthesize_batch(
                texts, duration_scale=scale), want, f"{cd} replay")}
        out[f"{cd}_graphs"] = s.graph_stats()
        if cd == "bf16":
            out["bf16_turns"] = []
            for mode in ("graph", "eager", "eager", "graph"):
                with graph_mode(mode):
                    out["bf16_turns"].append(
                        {"mode": mode, **_throughput(s, texts, scale)})
    out["launches"] = counters.read()
    return out


def _s1_state(t) -> dict:
    """A stage-1 trainer's gathered weights and Adam moments, on the
    host."""
    st = t._host_state_copy()
    out = {f"p.{k}": v for k, v in st["params"].items()}
    for m in ("mu", "nu"):
        out.update({f"{m}.{k}": v for k, v in st["opt_state"][m].items()})
    return out


def md_stage1_graphs(out_dir: str, dev: torch.device, mesh=None) -> dict:
    """The flagship stage-1 step (f32, TF32 off) at each bucket twice (a
    bucket's first call, eager then its capture, then a replay) on two
    trainers, as graphs and under ``disable_graphs()``, deterministic
    algorithms on (``_held_pair``); the graph run's losses and gathered
    weights after them; ms a step by bucket both ways; its graphs."""
    from m2tts_tpu_torch.training.trainer import Stage1Trainer
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pair = {mode: Stage1Trainer(train_config(
        FLAGSHIP_MODEL, FLAGSHIP_TRAINING, f"{out_dir}/{mode}", **MD_TRAIN),
        device=dev, mesh=mesh) for mode in ("eager", "graph")}
    g = pair["graph"]
    if g._graphs is None or (mesh is not None and g.mesh is None):
        raise RuntimeError(f"stage 1 on mesh {mesh}: no graphs")
    batches = bucket_batches(g, g._put)
    losses = []

    def step(t, b):
        out = t._train_step(b)
        t.step += 1
        if t is g:
            losses.append({k: v.item() for k, v in out.items()})
        return out

    held = _held_pair(pair, list(batches.values()) * 2, step, _s1_state,
                      f"stage 1 (mesh {mesh is not None})")
    out = {"held": held, "losses": losses,
           "params": g._host_state_copy()["params"],
           "graphs": g._graphs.stats(),
           "ms_per_step_by_bucket": _turns(g._train_step, batches, 3, 1)}
    for t in pair.values():
        t.close()
    del pair, g, batches
    torch.cuda.empty_cache()
    return out


def md_gan_graphs(out_dir: str, dev: torch.device, mesh=None) -> dict:
    """The flagship GAN step with the packed discriminator
    (FLAGSHIP_TRAINING: batch 32, bf16, 8192-sample segments) at the
    (128, 512) bucket twice on two trainers, as graphs and under
    ``disable_graphs()``, deterministic algorithms where they exist
    (``_held_pair``); the graph run's metrics and gathered generator; ms a
    step both ways; its graphs."""
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, FLAGSHIP_TRAINING

    pair = {mode: Stage2Trainer(train_config(
        FLAGSHIP_MODEL, FLAGSHIP_TRAINING, f"{out_dir}/{mode}",
        overrides=PACKED_OVERRIDES, **{"training.disc_lowering": "packed"}),
        device=dev, mesh=mesh) for mode in ("eager", "graph")}
    g = pair["graph"]
    if g._graphs is None or g.disc_lowering != "packed":
        raise RuntimeError(f"GAN step on mesh {mesh}: graphs {g._graphs}, "
                           f"lowering {g.disc_lowering}")
    b512 = {k: v for k, v in _s2_batches(g, cached=False).items()
            if k == tuple(g.buckets[1])}
    metrics = []

    def step(t, b):
        out = t.train_step(b)
        if t is g:
            metrics.append({k: v.item() for k, v in out.items()})
        return out

    held = _held_pair(pair, list(b512.values()) * 2, step, _s2_state,
                      f"GAN step (mesh {mesh is not None})")
    out = {"held": held, "losses": metrics,
           "params": g._host_state()["generator"],
           "graphs": g._graphs.stats(),
           "ms_per_step_by_bucket": _turns(g.train_step, b512, 3, 1)}
    for t in pair.values():
        t.close()
    del pair, g, b512
    torch.cuda.empty_cache()
    return out


def md_no_mesh(out_dir: str, scale: float) -> dict:
    """The same work without a mesh, in a new process as the ranks are (so
    that ms a step and ms a batch compare like with like): the gloo ranks'
    references (three stage-1 steps, the f32 GAN step, the synthesis), and
    the NCCL rank's (the stage-1 and GAN graphs held against eager, batch
    64 held and timed)."""
    torch.set_num_threads(1)  # as each rank of a world
    dev = _md_device()
    return {"stage1": md_stage1(f"{out_dir}/md_plain", dev),
            "stage1_graphs": md_stage1_graphs(f"{out_dir}/md_plain_g", dev),
            "gan_graphs": md_gan_graphs(f"{out_dir}/md_plain_gan", dev),
            "stage2": md_stage2(f"{out_dir}/md_plain_s2", dev),
            "synth": md_synth(scale, EVAL_TEXTS, dev),
            "synth64": md_synth(scale, (EVAL_TEXTS * 8)[:64], dev,
                                held=True)}


def md_world1_rank(out_dir: str, scale: float) -> dict:
    """World size 1 (NCCL on the card): on the (1, 1) mesh the stage-1 and
    GAN steps and the synthesis (the eight texts, then batch 64) as graph
    replays held against eager, to hold against ``mesh=None`` too."""
    from m2tts_tpu_torch.parallel.mesh import is_nccl, make_mesh

    dev = _md_device()
    mesh = make_mesh()
    if not is_nccl(mesh):
        raise RuntimeError("the one-rank world's mesh is not NCCL's")
    return {"backend": torch.distributed.get_backend(),
            "stage1_graphs": md_stage1_graphs(f"{out_dir}/md_world1", dev,
                                              mesh),
            "gan_graphs": md_gan_graphs(f"{out_dir}/md_world1_gan", dev,
                                        mesh),
            "synth": md_synth(scale, EVAL_TEXTS, dev, mesh),
            "synth64": md_synth(scale, (EVAL_TEXTS * 8)[:64], dev, mesh,
                                held=True)}


def md_gloo_rank(out_dir: str, scale: float) -> dict:
    """Two gloo ranks on the one card: stage-1 steps on (2, 1) and (1, 2),
    a GAN step on (2, 1), batch 64 × the 512 bucket sharded over 'data',
    and the dry run."""
    from m2tts_tpu_torch.parallel.dryrun import dryrun_multichip
    from m2tts_tpu_torch.parallel.mesh import make_mesh

    rank = torch.distributed.get_rank()
    dev = _md_device()
    out = {"backend": torch.distributed.get_backend(), "device": str(dev)}
    for d, m in ((2, 1), (1, 2)):
        out[f"stage1_{d}x{m}"] = md_stage1(
            f"{out_dir}/md_gloo_{d}x{m}_{rank}", dev,
            make_mesh(d, m))
    mesh = make_mesh(2, 1)
    out["stage2_2x1"] = md_stage2(f"{out_dir}/md_gloo_s2_{rank}", dev, mesh)
    out["synth64"] = md_synth(scale, (EVAL_TEXTS * 8)[:64], dev, mesh)
    out["dryrun"] = dryrun_multichip(2)
    return out


def _md_steps(got: dict, want: dict, loss_tol: dict, what: str,
              faults: list) -> dict:
    """Mesh steps against single-device steps: worst loss error (relative)
    and weight error (max abs); what passes ``loss_tol`` or
    ``MD_PARAMS_ATOL`` is added to ``faults``."""
    rel = 0.0
    for g, w in zip(got["losses"], want["losses"]):
        for k in w:
            err = abs(g[k] - w[k])
            rel = max(rel, err / max(abs(w[k]), 1e-30))
            if err > loss_tol["atol"] + loss_tol["rtol"] * abs(w[k]):
                faults.append(f"{what} {k}: {g[k]} against {w[k]}")
    params = max((got["params"][k] - v).abs().max().item()
                 for k, v in want["params"].items())
    if params > MD_PARAMS_ATOL:
        faults.append(f"{what}: weights {params} from one device's")
    out = {"loss_max_rel": rel, "params_max_abs": params}
    out.update({k: got[k] for k in ("ms_per_step", "mesh") if k in got})
    return out


def _md_synth(got: dict, want: dict, lsb: int, what: str,
              faults: list) -> dict:
    """Sharded synthesis against ``mesh=None``: frames equal, the worst
    PCM difference in LSB per dtype; what passes ``lsb`` goes to
    ``faults``."""
    out = {}
    for cd in ("bf16", "f32"):
        worst = 0
        for (fa, pa), (fb, pb) in zip(got[cd], want[cd]):
            if fa != fb or fa <= 0 or pa.shape != pb.shape:
                faults.append(f"{what} {cd}: frames {fa} against {fb}")
                continue
            worst = max(worst, int(np.abs(pa.astype(np.int32)
                                          - pb).max(initial=0)))
        if worst > lsb:
            faults.append(f"{what} {cd}: PCM {worst} LSB from mesh=None")
        out[f"{cd}_max_pcm_lsb"] = worst
    return out


def multi_device_phase(out_dir: str, scale: float, card: str) -> dict:
    """The mesh paths on the card, against the same work without a mesh in
    a new process: an NCCL world of one rank (stage-1 steps and synthesis
    equal to ``mesh=None``, 0 LSB, and what the mesh costs the host), then
    two gloo ranks sharing the card ((2, 1) and (1, 2) stage-1 steps, a
    (2, 1) GAN step, batch 64 × 512 sharded over 'data' within 1 LSB, the
    dry run). Returns the kernels' launches in the worlds."""
    import multiprocessing

    from m2tts_tpu_torch.parallel.mesh import spawn_world

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        plain = pool.apply(md_no_mesh, (out_dir, scale))
    t_nccl = time.perf_counter()
    nccl = spawn_world(md_world1_rank, 1, args=(out_dir, scale),
                       backend="nccl", device="cuda", timeout=300)[0]
    t_gloo = time.perf_counter()
    gloo = spawn_world(md_gloo_rank, 2, args=(out_dir, scale),
                       backend="gloo", device="cuda", timeout=400)
    t_end = time.perf_counter()
    if nccl["backend"] != "nccl" or any(r["backend"] != "gloo"
                                         for r in gloo):
        raise RuntimeError("a world ran on another backend than asked")

    faults: list = []
    world1_tol = {"rtol": TRAIN_VS_CPU["loss_rel"], "atol": 0}
    world1 = {"backend": nccl["backend"], "seconds": t_gloo - t_nccl}
    for key, what in (("stage1_graphs", "stage 1"), ("gan_graphs", "GAN")):
        m, p = nccl[key], plain[key]
        world1[key] = {
            "graph_vs_eager": {"mesh": m["held"], "no_mesh": p["held"]},
            "mesh_vs_no_mesh": _md_steps(m, p, world1_tol,
                                         f"world 1 (1, 1) {what}", faults),
            "graphs": {"mesh": m["graphs"], "no_mesh": p["graphs"]},
            "ms_per_step_by_bucket": {
                "mesh": m["ms_per_step_by_bucket"],
                "no_mesh": p["ms_per_step_by_bucket"]}}
        if m["graphs"]["graphs"] < 1 or m["graphs"]["replays"] < 1:
            faults.append(f"world 1 {what}: graphs {m['graphs']}")
    world1.update({
        "synth_8": _md_synth(nccl["synth"], plain["synth"], 0,
                             "world 1 (1, 1) synthesis", faults),
        "synth_64": _md_synth(nccl["synth64"], plain["synth64"], 0,
                              "world 1 (1, 1) batch 64", faults),
        "synth_64_vs_eager": {cd: nccl["synth64"][f"{cd}_vs_eager"]
                              for cd in ("bf16", "f32")},
        "synth_64_graphs": {cd: nccl["synth64"][f"{cd}_graphs"]
                            for cd in ("bf16", "f32")},
        "batch64_bf16_turns": {"mesh": nccl["synth64"]["bf16_turns"],
                               "no_mesh": plain["synth64"]["bf16_turns"]},
        "launches": {k: nccl["synth"]["launches"][k]
                     + nccl["synth64"]["launches"][k]
                     for k in Counters.NAMES}})
    for cd in ("bf16", "f32"):
        if nccl["synth64"][f"{cd}_graphs"]["replays"] < 1:
            faults.append(f"world 1 batch 64 {cd}: no replay")
    world2 = {"ranks": []}
    for r, res in enumerate(gloo):
        s2 = res["stage2_2x1"]
        for k, v in plain["stage2"].items():
            if abs(s2[k] - v) > MD_LOSS["atol"] + MD_LOSS["rtol"] * abs(v):
                faults.append(f"(2, 1) GAN step {k}: {s2[k]} against {v}")
        world2["ranks"].append({
            "device": res["device"],
            **{key: _md_steps(res[key], plain["stage1"], MD_LOSS,
                              f"gloo {key} rank {r}", faults)
               for key in ("stage1_2x1", "stage1_1x2")},
            "stage2_2x1_max_rel": max(
                abs(s2[k] - v) / max(abs(v), 1e-30)
                for k, v in plain["stage2"].items()),
            "synth64_2x1": _md_synth(res["synth64"], plain["synth64"], 1,
                                     f"gloo (2, 1) batch 64 rank {r}",
                                     faults),
            "launches": res["synth64"]["launches"],
            "dryrun": res["dryrun"]})
    world2["seconds"] = t_end - t_gloo
    launches = {k: world1["launches"][k]
                + sum(r["launches"][k] for r in world2["ranks"])
                for k in Counters.NAMES}
    out = {"phase": "multi_device", "card": card,
           "nccl_world_1": world1, "gloo_world_2_on_one_card": world2,
           "launches": launches, "batch64_shape": [64, 512, 80],
           "bars": {"world_1_loss_rel": TRAIN_VS_CPU["loss_rel"],
                    "loss": MD_LOSS,
                    "params_abs": MD_PARAMS_ATOL,
                    "graph_vs_eager": {"bitwise_or_rel": GRAPH_NONDET,
                                       "pcm_lsb": 0},
                    "pcm_lsb": {"world_1": 0, "gloo_2x1": 1}},
           "faults": faults, "seconds": time.perf_counter() - t0,
           "reference_seconds": t_nccl - t0}
    emit(out)
    if faults:
        raise RuntimeError(f"multi_device: {faults}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"the mesh paths skipped a kernel: {launches}")
    return out


# the data-backed path: a v3 corpus built by the port, its STOI floors held
# to the repo's round-5 measurement (the first 16 utterances of every v3
# corpus are the same: one default_rng(42) stream), then stage 1 and a
# warm-started stage 2 trained on it (CUDA graph replays), and both stage-2
# checkpoints evaluated with audio metrics and served through the kernel
CORPUS_N = 64
CORPUS_FLOOR_N = 16
CORPUS_FLOORS_REF = "artifacts/evidence_r05/corpus_floors.json"
CORPUS_FLOORS_TOL = 1e-4
CORPUS_TRAIN = {"training.max_steps": 300, "training.log_every": 50,
                "training.validate_every": 100, "training.save_every": 1000,
                "training.warmup_steps": 50, "training.learning_rate": 5e-4,
                "training.device_data_cache": True}
CORPUS_STAGE2 = {"training.max_steps": 40, "training.log_every": 10,
                 "training.validate_every": 40, "training.save_every": 20,
                 "training.warmup_steps": 10,
                 "training.device_data_cache": True}


def corpus_drive_phase(out_dir: str, card: str, counters: Counters) -> dict:
    """Build a 64-utterance v3 corpus with ``data.download_data``, hold its
    floors (``evaluation.corpus_floors``, n = 16) to the round-5 JSON, then
    train the flagship stage 1 (bf16, device cache) on ``TTSDataset`` (its
    validation loss must fall), warm-start stage 2 on the recipe with one
    quality validation, and run ``evaluation.evaluate --audio-metrics`` on
    stage 2's ``best`` and earliest checkpoints with two ``-t`` texts (bf16
    on ``vocoder_tc.cu``)."""
    from pathlib import Path

    from m2tts_tpu_torch.data.download_data import build_synthetic_corpus
    from m2tts_tpu_torch.evaluation import corpus_floors
    from m2tts_tpu_torch.evaluation import evaluate as cli
    from m2tts_tpu_torch.training.trainer import build_dataset
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING,
                                              STAGE2_TRAINING)

    t_phase = time.perf_counter()
    counters.zero()
    t0 = time.perf_counter()
    corpus = str(build_synthetic_corpus(Path(out_dir) / "data", CORPUS_N,
                                        profile="v3"))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    floors = json.loads(run_cli(corpus_floors.main, [
        "--data-dir", corpus, "--n", str(CORPUS_FLOOR_N), "--profile",
        "v3"]).strip().splitlines()[-1])
    floors_s = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CORPUS_FLOORS_REF)) as f:
        ref = json.load(f)
    floors_err = {k: abs(floors[k] - ref[k]) for k in floors
                  if k in ref and k not in ("corpus", "n_utterances")}
    if len(floors_err) != 5 or max(floors_err.values()) > CORPUS_FLOORS_TOL:
        raise RuntimeError(f"corpus floors {floors} against {ref}")

    cfg1 = train_config(FLAGSHIP_MODEL, FLAGSHIP_TRAINING,
                        f"{out_dir}/stage1", CORPUS_TRAIN,
                        **{"data.data_dir": corpus})
    t0 = time.perf_counter()
    ingest = len(build_dataset(cfg1.get("data")))
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ingest_audio = len(build_dataset(cfg1.get("data"), keep_audio=True))
    ingest_audio_s = time.perf_counter() - t0
    run1 = train_run(cfg1, card, dataset="TTSDataset")
    if len(run1["trainer"].dataset) != CORPUS_N or ingest != CORPUS_N \
            or ingest_audio != CORPUS_N:
        raise RuntimeError(f"TTSDataset of {len(run1['trainer'].dataset)} "
                           f"samples (ingest {ingest}, {ingest_audio} with "
                           f"audio), expected {CORPUS_N}")
    stage1_dir, stage1_report = run1["trainer"].ckpt.directory, run1["report"]
    run1["trainer"].close()

    cfg2 = train_config(FLAGSHIP_MODEL, STAGE2_TRAINING, f"{out_dir}/stage2",
                        CORPUS_STAGE2,
                        **{"data.data_dir": corpus,
                           "training.init_generator_from": str(stage1_dir)})
    run2 = stage2_run(cfg2, card, dataset="TTSDataset")
    stage2_dir, stage2_report = run2["trainer"].ckpt.directory, run2["report"]
    early = min(run2["trainer"].ckpt.all_steps())
    run2["trainer"].close()
    del run1, run2
    torch.cuda.empty_cache()

    evals = {}
    for step in ("best", str(early)):
        t0 = time.perf_counter()
        report = json.loads(run_cli(cli.main, [
            "--checkpoint", str(stage2_dir), "--step", step, "--data-dir",
            corpus, "--audio-metrics", "--json", "--num-samples", "16",
            "-t", EVAL_TEXTS[0], "-t", EVAL_TEXTS[5]]).strip()
            .splitlines()[-1])
        ds = report.get("dataset", {})
        if not {"audio_stoi", "audio_log_spectral_distance"} <= set(ds) \
                or not all(np.isfinite(v) for v in ds.values()) \
                or len(report.get("texts", [])) != 2:
            raise RuntimeError(f"evaluate --step {step}: {report}")
        evals[step] = {**ds, "estimated_mos_mean":
                       report["estimated_mos_mean"],
                       "seconds": time.perf_counter() - t0}
    launches = counters.read()
    if launches["fused_vocoder_tc"] < 1:
        raise RuntimeError(f"evaluate -t skipped the kernel: {launches}")
    out = {"phase": "corpus_drive", "card": card, "utterances": CORPUS_N,
           "corpus_build_s": build_s, "floors": floors,
           "floors_abs_err_vs_round5": floors_err, "floors_s": floors_s,
           "ingest_s": ingest_s, "ingest_with_audio_s": ingest_audio_s,
           "stage1": stage1_report, "stage2": stage2_report,
           "eval_early_step": early, "evaluate": evals,
           "launches": launches, "seconds": time.perf_counter() - t_phase}
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
    for _ in range(2):  # the bucket's capture, then its first replay
        synth.synthesize_batch(texts64, duration_scale=scale)
    torch.cuda.synchronize()
    iters, audio_s, call_ms = 5, 0.0, []
    t0 = time.perf_counter()
    for _ in range(iters):
        t1 = time.perf_counter()
        out = synth.synthesize_batch(texts64, duration_scale=scale)
        call_ms.append((time.perf_counter() - t1) * 1e3)
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
          "ms_per_call": call_ms, "card": card})
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
    # ---- 4b. the CUDA graphs of the main path, streaming and stage 1
    # against eager, on the weights the main path ran (http's /reload
    # swaps them), with figures
    graphs = cuda_graphs_phase(synth, synth_f32, scale, results, card,
                               counters, buckets)
    graphs_path, host_probe_path = (graphs["launches"],
                                    graphs["host_probe"]["launches"])
    del graphs

    # ---- 5. streaming, the batchers and the HTTP server; each path with
    # the counters zeroed just before it and read just after
    streaming = streaming_phase(synth.model, scale, synth.sample_rate, card,
                                counters)
    ss16 = streaming["streamers"]["bf16"]
    if "--profile" in sys.argv[1:]:
        for cd, ss in streaming["streamers"].items():
            emit(profile_batch(lambda: list(ss.stream(EVAL_TEXTS[4], scale)),
                               card, phase=f"stream_profile_{cd}"))
    paths = {"main_path": launches, "cuda_graphs": graphs_path,
             "host_probe": host_probe_path,
             "streaming": streaming["launches"]}
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
        stage1_dir = train["runs"]["prefetcher"]["trainer"].ckpt.directory
        for run in train["runs"].values():
            run["trainer"].close()
        del train
        torch.cuda.empty_cache()

        # ---- 7. stage 2 on the stage-1 checkpoints, then its checkpoints
        # served through the kernel
        stage2 = train_stage2_phase(f"{tdir}/stage2", card, stage1_dir,
                                    f"{tdir}/xl/checkpoints",
                                    "--profile" in sys.argv[1:])
        train_stage2_vs_cpu_phase(f"{tdir}/stage2", card)
        paths["train_stage2_to_serve"] = train_stage2_to_serve_phase(
            stage2, buckets, card, counters, lsb_bar["bf16"])["launches"]
        stage2_dir = stage2["runs"]["prefetcher"]["trainer"].ckpt.directory
        for run in stage2["runs"].values():
            run["trainer"].close()
        del stage2
        torch.cuda.empty_cache()

        # ---- 7b. the phase-packed discriminator: the lowering alone, in
        # the stage-2 trainer, then the pipeline smoke suite
        disc_lowering_phase(card)
        packed = train_stage2_packed_phase(
            f"{tdir}/stage2_packed", card, stage1_dir, buckets, counters)
        paths["train_stage2_packed"] = packed["launches"]
        # ---- 7c. the training graphs against eager, with their figures
        train_stage2_graphs_phase(f"{tdir}/stage2_graphs", card, stage1_dir,
                                  packed)
        del packed
        paths["pipeline_smoke"] = pipeline_smoke_phase(card,
                                                       counters)["launches"]

        # ---- 8. the deployment surface: the synthesize CLI on the stage-2
        # checkpoint, export artifacts, the native mel frontend, the
        # evaluate CLI on the stage-1 checkpoint, the device utilities
        clips = write_corpus(f"{tdir}/corpus")
        native_frontend_phase(clips, card)  # first: it times the build
        os.makedirs(f"{tdir}/cli")
        paths["synthesize_cli"] = synthesize_cli_phase(
            stage2_dir, f"{tdir}/cli", card, counters)["launches"]
        paths["export"] = export_phase(synth, scale, tdir, card, counters,
                                       lsb_bar)["launches"]
        paths["evaluate_cli"] = evaluate_cli_phase(
            stage1_dir, f"{tdir}/corpus", card, counters)["launches"]
        device_info_phase(card)

        # ---- 9. the mesh paths, in worlds of processes spawned here
        paths["multi_device"] = multi_device_phase(tdir, scale,
                                                   card)["launches"]

        # ---- 10. the data-backed path: a corpus built by the port, its
        # floors, both stages trained on it, its checkpoints evaluated
        paths["corpus_drive"] = corpus_drive_phase(
            f"{tdir}/corpus_drive", card, counters)["launches"]

    # ---- 11. kernels line, then the result
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
