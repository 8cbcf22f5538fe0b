"""The serving path's spans and work counters (``utils/profiling.py``) on
the CPU: off, ``span`` is one shared null context that allocates and
records nothing; on, a ``synthesize_batch`` call gives ``synth.launch``
holding ``synth.encode``, ``synth.probe`` and ``synth.enqueue`` and
``synth.collect`` holding ``synth.fetch`` and ``synth.unpack``, all with
the call's number as ident and nested in time, and the same PCM as with
tracing off; the Synthesizer's frame counters equal the bucket arithmetic
of the frame counts its probe predicts, a truncated row included; under
concurrent ``stream()`` calls the StreamBatcher records one
``stream.queued`` per request, each naming a recorded admission pass, its
counters count every request and at least every device call, and the
spans read as never overlapping do not overlap. Every thread is a daemon,
every join has a timeout. Each test reads only the spans of threads it
did not find running: a batcher another test module left running (the
server's handler keeps its batchers) records spans of its own."""

import threading
import tracemalloc

import numpy as np
import pytest
import torch

from m2tts_tpu_torch.models.tts_model import M2TTS, init_params
from m2tts_tpu_torch.serving.pipeline import Synthesizer, _bucket_for
from m2tts_tpu_torch.serving.stream_batcher import StreamBatcher
from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer
from m2tts_tpu_torch.utils import profiling

torch.set_num_threads(2)

KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
BUCKETS = dict(text_buckets=(32,), frame_buckets=(32, 64),
               batch_buckets=(1, 2, 8))
STREAM_KW = dict(chunk_frames=16, max_frames=64, text_bucket=32)
TEXTS = ["hello world", "a second caller", "third request here"]
STREAM_TEXTS = ["hello world", "streaming in batches", "a",
                "the quick brown fox", "packed lanes share one dispatch",
                "six", "seven streams at once", "eight"]
SCALE = 8.0
TIMEOUT = 120
#: names whose spans one thread at a time opens (never overlapping)
SERIAL = ("stream.admit_window", "stream.admit_pass", "stream.sched_wait",
          "stream.dispatch", "stream.chunk_run", "stream.hand_out",
          "stream.short")


@pytest.fixture(scope="module")
def model():
    return init_params(M2TTS(**KW), torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def synth(model):
    return Synthesizer(model, device="cpu", **BUCKETS)


@pytest.fixture
def tracing():
    """Tracing on for the test, off and empty after it."""
    profiling.drain()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.drain()


@pytest.fixture
def ours():
    """``ours(spans)``: the spans of the test's own threads, leaving out
    those of every other thread already running when the test started."""
    me = threading.get_ident()
    foreign = {t.ident for t in threading.enumerate()} - {me}
    return lambda spans: [s for s in spans if s[3] not in foreign]


def _within(child, parent) -> bool:
    return parent[4] <= child[4] <= child[5] <= parent[5]


def test_span_off_is_one_null_context_and_allocates_nothing():
    profiling.disable()
    profiling.drain()
    assert profiling.span("a") is profiling.span("b", 7, 8)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("synth.launch", 12345, 12345):
                profiling.record("stream.queued", 1, 2, 3, 4)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "lineno")
    assert sum(d.size_diff for d in grown) == 0, grown[:3]
    assert sum(d.count_diff for d in grown) == 0
    assert profiling.drain() == []


def test_span_on_records_nested_spans_and_drain_empties(tracing):
    with profiling.span("outer", 1):
        with profiling.span("inner", 1, 1):
            pass
    profiling.record("wait", 5, 9, 2, 1)
    spans = profiling.drain()
    assert [s[:3] for s in spans] == [("inner", 1, 1), ("outer", 1, None),
                                      ("wait", 2, 1)]
    assert {s[3] for s in spans} == {threading.get_ident()}
    assert _within(spans[0], spans[1]) and spans[2][4:] == (5, 9)
    assert profiling.drain() == []


def test_synthesize_batch_spans_nest_under_one_call(synth, tracing, ours):
    synth.synthesize_batch(TEXTS, SCALE)
    synth.synthesize_batch(TEXTS[:1], SCALE)
    spans = ours(profiling.drain())
    by_call = {}
    for s in spans:
        by_call.setdefault(s[1], {})[s[0]] = s
    assert len(by_call) == 2 and None not in by_call
    for call, got in by_call.items():
        assert set(got) == {"synth.launch", "synth.encode", "synth.probe",
                            "synth.enqueue", "synth.collect", "synth.fetch",
                            "synth.unpack"}
        launch, collect = got["synth.launch"], got["synth.collect"]
        assert launch[2] is None and collect[2] is None
        assert launch[5] <= collect[4]
        parts = [("synth.launch", ("synth.encode", "synth.probe",
                                   "synth.enqueue")),
                 ("synth.collect", ("synth.fetch", "synth.unpack"))]
        for parent, children in parts:
            prev = got[parent][4]
            for name in children:
                child = got[name]
                assert child[2] == call and _within(child, got[parent])
                assert child[4] >= prev  # in order, one after the other
                prev = child[5]


def test_tracing_changes_no_pcm(synth):
    profiling.disable()
    off = synth.synthesize_batch(TEXTS, SCALE)
    profiling.enable()
    try:
        on = synth.synthesize_batch(TEXTS, SCALE)
    finally:
        profiling.disable()
        profiling.drain()
    assert [r["audio_pcm"].tobytes() for r in off] == \
        [r["audio_pcm"].tobytes() for r in on]


@pytest.mark.parametrize("scale", [4.0, SCALE], ids=["fits", "truncates"])
def test_frame_counters_follow_the_buckets(model, scale):
    synth = Synthesizer(model, device="cpu", **BUCKETS)
    texts = TEXTS + ["a much longer sentence than all the others here"]
    enc = synth.text_processor.batch(texts, 32)
    totals = synth.predict_frames(np.asarray(enc["phoneme_ids"]),
                                  np.asarray(enc["lengths"]), scale)
    bucket = _bucket_for(int(totals.max()), BUCKETS["frame_buckets"])
    cut = int((totals > bucket).sum())
    assert (cut > 0) is (scale == SCALE)  # the case's premise
    for _ in range(2):
        results = synth.synthesize_batch(texts, scale)
    # 4 texts take the batch bucket 8
    assert (synth.calls, synth.frames_run) == (2, 2 * 8 * bucket)
    assert synth.frames_served == 2 * int(np.minimum(totals, bucket).sum())
    assert synth.truncated == 2 * cut
    assert sum(bool(r.get("truncated")) for r in results) == cut


def _stream_all(sb, texts):
    got, errors = [None] * len(texts), []

    def run(i):
        try:
            got[i] = list(sb.stream(texts[i], SCALE, timeout=TIMEOUT))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert not errors
    return got


def test_stream_batcher_spans_and_counters(model, tracing, ours):
    streamer = StreamingSynthesizer(model, device="cpu", **STREAM_KW)
    # a wide admission window, so concurrent callers share passes
    sb = StreamBatcher(streamer, max_streams=4, max_wait_ms=200.0)
    try:
        _stream_all(sb, STREAM_TEXTS)
    finally:
        sb.close()
    spans = ours(profiling.drain())
    # a text over the streamer's phoneme budget is admitted a sentence
    # chunk at a time
    sent = sum(len(streamer.split_long(t)) for t in STREAM_TEXTS)
    names = [s[0] for s in spans]
    passes = {s[1] for s in spans if s[0] == "stream.admit_pass"}
    queued = [s for s in spans if s[0] == "stream.queued"]
    assert len(queued) == sent
    assert len({s[1] for s in queued}) == len(queued)
    assert all(s[2] in passes for s in queued)
    assert len(passes) == sb.admit_passes < sent
    assert sb.admitted == sent
    # every device call took the lock: passes, chunk calls, short calls
    shorts = names.count("stream.short")
    assert shorts > 0 and sb.chunk_dispatches > 0
    assert sb.lock_acquires >= sb.admit_passes + sb.chunk_dispatches + shorts
    assert sb.lock_acquires == names.count("stream.lock_wait")
    assert sb.lock_wait_ns >= 0
    assert names.count("stream.dispatch") == sb.chunk_dispatches
    for name in SERIAL:
        got = sorted(s[4:] for s in spans if s[0] == name)
        assert got, name
        assert all(a[1] <= b[0] for a, b in zip(got, got[1:])), name
    dispatches = {s[1]: s for s in spans if s[0] == "stream.dispatch"}
    for s in spans:
        if s[0] in ("stream.chunk_run", "stream.hand_out"):
            assert _within(s, dispatches[s[2]])


def test_stream_batcher_records_nothing_with_tracing_off(model, ours):
    profiling.disable()
    profiling.drain()
    streamer = StreamingSynthesizer(model, device="cpu", **STREAM_KW)
    sb = StreamBatcher(streamer, max_streams=4, max_wait_ms=20.0)
    try:
        _stream_all(sb, STREAM_TEXTS[:4])
    finally:
        sb.close()
    assert ours(profiling.drain()) == []
    assert sb.admitted == 4 and sb.lock_acquires >= sb.admit_passes > 0
