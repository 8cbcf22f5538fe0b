"""Interactive streaming: Poisson arrivals at a fixed rate, each a client
that opens ``StreamBatcher.stream`` and drains its chunks, in process and
without HTTP, the batcher built as the server's ``/synthesize_stream``
route builds it under ``--dynamic-batch``.

End to end: ``first_chunk_p50_ms``, the median over every request sent in
the window of the time from its scheduled send to its first chunk in the
client's hands (a failed request counts as missing). Its 95th percentile,
which swings with the host's stalls far more than the median, is read per
layer (``first_chunk_p95_ms.stream``) and printed in every run. The mix's
``clients`` threads, started in set-up, each drive one request at a time
from its send to its last chunk, as a server's handler threads do; the
run reports how many requests ever waited for a free one. Traced: each
request's admission time, the batcher's chunk counters, the vocoder
launches' shapes, the host spans of the batcher's calls (the admission's
batched acoustic pass, each chunk dispatch, each short-path call, every
one until its result is on the host) and the FLOPs of the audio streamed.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import compare, traffic
from portbench.cellkit import Cell, free_device, pick_sample
from portbench.harness import forbidden_modules, say
from portbench.trace import Window, union_ns
from portbench.work import ModelFlops, launch_bound_ms

DRAIN_S = 60.0  # how long past the window a request may still finish
WARM_STREAMS = 8


class _Client:
    __slots__ = ("sched", "admit", "first", "done", "samples", "keep",
                 "error")

    def __init__(self, sched: float, keep: bool):
        self.sched = sched
        self.admit = self.first = self.done = None
        self.samples = 0
        self.keep: Optional[List[np.ndarray]] = [] if keep else None
        self.error: Optional[str] = None


def _drive(sb, text: str, scale: float, c: _Client) -> None:
    try:
        chunks = sb.stream(text, scale, timeout=DRAIN_S)
        c.admit = time.perf_counter()
        for ch in chunks:
            if c.first is None:
                c.first = time.perf_counter()
            c.samples += len(ch)
            if c.keep is not None:
                c.keep.append(np.array(ch, dtype=np.float32))
        c.done = time.perf_counter()
    except Exception as e:  # a failed request: counted, never retried
        c.error = repr(e)


def build(cell: Cell):
    """(Synthesizer, StreamingSynthesizer, StreamBatcher) as the server
    makes them: the streamer at the largest frame and text buckets, the
    Synthesizer's backend and dtype, one device lock."""
    from m2tts_tpu_torch.serving.stream_batcher import StreamBatcher
    from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer

    synth = cell.build_synthesizer()
    st = cell.serving["stream"]
    ss = StreamingSynthesizer(
        synth.model, chunk_frames=int(st["chunk_frames"]),
        max_frames=max(synth.frame_buckets),
        text_bucket=max(synth.text_buckets),
        vocoder_backend=synth.vocoder_backend,
        compute_dtype=synth.compute_dtype, sample_rate=synth.sample_rate,
        device=synth.device)
    sb = StreamBatcher(ss, lock=threading.Lock(),
                       max_streams=int(st["max_streams"]),
                       max_wait_ms=float(st["max_wait_ms"]))
    return synth, ss, sb


def _warm_short(ss, sb, lo: int) -> int:
    """Capture the short path's graph of every length from ``lo`` to one
    window (one graph per length)."""
    import torch

    sv = ss.vocoder
    C = sv.model.mel_channels
    n = 0
    with sb.lock, torch.inference_mode():
        for T in range(max(lo, 1), sv._window + 1):
            sv._short(torch.zeros((T, C), device=ss.device))
            n += 1
    return n


def _time_calls(sb) -> Dict[str, List]:
    """Wrap the batcher's three kinds of device call (its own methods,
    each timed until its result is on the host) in host-clock spans; the
    lists of ``(start, end)`` it fills, by kind."""
    calls: Dict[str, List] = {"admit": [], "dispatch": [], "short": []}
    admit, dispatch, short = sb._admit_batch, sb._dispatch, sb._stream_short

    def timed(fn, into):
        def call(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                into.append((t, time.perf_counter()))
        return call

    def timed_short(mel, frames):
        # a generator: the device call runs when the client first asks
        t = time.perf_counter()
        chunks = list(short(mel, frames))
        calls["short"].append((t, time.perf_counter()))
        yield from chunks

    sb._admit_batch = timed(admit, calls["admit"])
    sb._dispatch = timed(dispatch, calls["dispatch"])
    sb._stream_short = timed_short
    return calls


def _graphs(ss) -> int:
    return len(ss.graphs) + len(ss.vocoder.graphs)


def run(ctx) -> Dict:
    mix, seed = ctx.mix, ctx.seed
    rate, seconds = float(mix["rate_per_s"]), float(ctx.seconds)
    n = max(1, int(round(rate * seconds)))
    cell = Cell(ctx.config, mix, seed, ctx.device, n, ctx.mark)
    times = traffic.arrivals(rate, seconds, traffic.rng_for(seed, "arrivals"))
    sample = pick_sample(cell, n)

    synth, ss, sb = build(cell)
    ctx.mark("build_and_kernels")
    ctx.inject(sb)
    W = ss.vocoder._window
    todo: "queue.SimpleQueue[Optional[int]]" = queue.SimpleQueue()
    workers: List[threading.Thread] = []
    try:
        n_warm = sb.warmup() + _warm_short(ss, sb, int(cell.totals.min()) - 8)
        ctx.mark("graph_capture")
        warm = [_Client(0.0, False) for _ in range(WARM_STREAMS)]
        threads = [threading.Thread(target=_drive, daemon=True,
                                    args=(sb, cell.texts[i], cell.scale, c))
                   for i, c in enumerate(warm)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DRAIN_S)
        if any(c.error for c in warm) or any(t.is_alive() for t in threads):
            raise RuntimeError(f"warm-up streams failed: "
                               f"{[c.error for c in warm if c.error]}")
        ctx.mark("warm_calls")
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"loaded at the end of set-up: {found}")
        graphs0 = _graphs(ss)
        say(f"set-up: {n_warm} streaming calls warmed, {graphs0} graphs, "
            f"duration scale {cell.scale!r}, {n} requests at {rate}/s, "
            f"{int((cell.totals <= W).sum())} within one window, mean "
            f"{cell.totals.mean() * cell.hop / cell.sr:.3f} s")

        launches = []
        if ctx.trace:
            sv = ss.vocoder
            run_chunk, short = sv._run_chunk, sv._short

            def rec_chunk(mel):
                launches.append((int(mel.shape[0]), int(mel.shape[1]),
                                 sv.compute_dtype))
                return run_chunk(mel)

            def rec_short(mel):
                if mel.shape[0]:
                    launches.append((1, int(mel.shape[0]), "f32"))
                return short(mel)

            sv._run_chunk, sv._short = rec_chunk, rec_short
            calls = _time_calls(sb)

        clients = [_Client(0.0, i in sample) for i in range(n)]

        def worker():
            while True:
                i = todo.get()
                if i is None:
                    return
                _drive(sb, cell.texts[i], cell.scale, clients[i])

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(int(mix["clients"]))]
        for t in workers:
            t.start()
        late = np.zeros(n)
        waiting = 0  # the most requests sent and not yet taken by a client
        ctx.setup_done()
        c0 = (sb.chunks_emitted, sb.chunk_dispatches)
        with Window(ctx.device, ctx.trace) as win:
            for i, at in enumerate(times):
                due = win.t0 + float(at)
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                clients[i].sched = due
                late[i] = time.perf_counter() - due
                todo.put(i)
                waiting = max(waiting, todo.qsize())
            for _ in workers:
                todo.put(None)
            limit = win.t0 + seconds + DRAIN_S
            for t in workers:
                t.join(max(0.0, limit - time.perf_counter()))
            win.close()
        c1 = (sb.chunks_emitted, sb.chunk_dispatches)
        hung = sum(t.is_alive() for t in workers)
        graphs1 = _graphs(ss)
    finally:
        for _ in workers:
            todo.put(None)
        sb.close()
    if graphs1 != graphs0:
        say(f"WARNING: {graphs1 - graphs0} graphs captured inside the window")
    peak = ctx.memory_peak()
    failed = [i for i, c in enumerate(clients) if c.error or c.first is None]
    say(f"window: {n} requests in {win.wall_s:.3f} s, {len(failed)} failed "
        f"({hung} unfinished), generator late by p95 "
        f"{np.percentile(late, 95) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} "
        f"ms, at most {waiting} sent requests waiting for one of the "
        f"{len(workers)} clients")
    for i in failed[:5]:
        say(f"request {i} failed: {clients[i].error}")
    first = np.array([(c.first - c.sched) * 1e3 if c.first is not None
                      and c.error is None else np.inf for c in clients])
    p50, p95 = (float(np.percentile(first, q)) for q in (50, 95))
    quarters = [float(np.percentile(q, 95)) for q in np.array_split(first, 4)]
    say(f"first chunk (ms): p50 {p50!r}, p95 {p95!r}")
    say("first-chunk p95 by quarter of the sends (ms): "
        + ", ".join(f"{q:.3f}" for q in quarters))
    record = {
        "admit_ms": [(c.admit - c.sched) * 1e3 for c in clients
                     if c.admit is not None],
        "chunks_emitted": c1[0] - c0[0], "chunk_dispatches": c1[1] - c0[1],
        "first_chunk_p95_ms": p95,
        "first_chunk_p95_by_quarter_ms": quarters}
    if ctx.trace:
        win.add_spans("admit", calls["admit"])
        win.add_spans("dispatch", calls["dispatch"])
        record.update(win.record())
        record["calls_s"] = union_ns(
            (a * 1e9, b * 1e9) for v in calls.values() for a, b in v) / 1e9
        counter = ModelFlops(ctx.config["model"])
        hop = cell.hop
        record["model_flops"] = sum(
            counter.utterance(int(cell.phonemes[i]), c.samples // hop)
            for i, c in enumerate(clients) if c.done is not None)
        s = cell.sizes
        record["vocoder_bound_s"] = sum(
            launch_bound_ms(b, T, s.mel, s.channels, s.rates, cd)
            for b, T, cd in launches) / 1e3
    del synth, ss, sb
    free_device(ctx.device)

    kept = [i for i, c in enumerate(clients)
            if c.keep is not None and i not in failed]
    pairs = [(np.concatenate(clients[i].keep) if clients[i].keep
              else np.zeros(0, np.float32),
              cell.stream_audio(cell.texts[i], W)) for i in kept]
    nums = compare.numbers(pairs, cell.hop, kept)
    say(f"worst compared utterance: {nums['worst']}")
    say(f"compared (frames, p50, p75, p90): {nums.pop('each')}")
    return {"attempted": n, "failed": len(failed),
            "metrics": {"first_chunk_p50_ms": p50},
            "numbers": nums, "record": record, "window": win,
            "memory_peak_bytes": peak}
