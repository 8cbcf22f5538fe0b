"""Request batching of the PyTorch port on the CPU: ``DynamicBatcher``
gives each caller what one ``synthesize_batch`` call gives (and the JAX
package's frames exactly, PCM within ±1 LSB), groups by (scale, format),
drains on close and fans a failure out to every caller of its batch;
``StreamBatcher`` streams equal the port's solo streams (atol 3e-5) and the
JAX package's solo streams (chunk lengths exactly, audio atol 1e-5) under
concurrency, with fewer chunk calls than chunks, for mixed scales and long
texts; ``warmup`` runs exactly the reachable batch buckets. Every thread is
a daemon, every join and wait has a timeout."""

import sys
import threading
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import M2TTS as JaxM2TTS
from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer
from m2tts_tpu.serving.streaming import \
    StreamingSynthesizer as JaxStreamingSynthesizer
from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.ops.audio_codec import mulaw_encode_np
from m2tts_tpu_torch.serving.batcher import DynamicBatcher
from m2tts_tpu_torch.serving.pipeline import Synthesizer
from m2tts_tpu_torch.serving.stream_batcher import StreamBatcher
from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
BUCKETS = dict(text_buckets=(32,), frame_buckets=(64,),
               batch_buckets=(1, 2, 8))
STREAM_KW = dict(chunk_frames=16, max_frames=64, text_bucket=32)
TEXTS = ["hello world", "a second caller", "third request here",
         "four is a crowd", "five alive", "the sixth sense"]
STREAM_TEXTS = ["hello world", "streaming in batches", "a",
                "the quick brown fox", "packed lanes share one dispatch"]
SCALE = 8.0
TIMEOUT = 120


@pytest.fixture(scope="module")
def models():
    jm = JaxM2TTS(**KW)
    params = jax.device_get(jax.jit(partial(
        jm.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tm = M2TTS(**KW)
    tm.load_state_dict(from_flax(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def synth(models):
    return Synthesizer(models[2], device="cpu", **BUCKETS)


@pytest.fixture(scope="module")
def jax_synth(models):
    return JaxSynthesizer(models[0], models[1], **BUCKETS)


@pytest.fixture(scope="module")
def streamer(models):
    return StreamingSynthesizer(models[2], device="cpu", **STREAM_KW)


@pytest.fixture(scope="module")
def jax_streamer(models):
    return JaxStreamingSynthesizer(models[0], models[1], **STREAM_KW)


def run_threads(fn, n):
    """fn(i) in n daemon threads released together; returns the results
    and raises the first error."""
    results, errors = [None] * n, []
    barrier = threading.Barrier(n)

    def worker(i):
        try:
            barrier.wait(timeout=TIMEOUT)
            results[i] = fn(i)
        except BaseException as e:  # surfaced in the test thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    if errors:
        raise errors[0]
    return results


class _Counting:
    """A Synthesizer that records each synthesize_batch call."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def synthesize_batch(self, texts, scale, **kw):
        self.calls.append((len(texts), scale, kw.get("pcm_format")))
        return self._inner.synthesize_batch(texts, scale, **kw)


# -- DynamicBatcher -----------------------------------------------------------

def test_concurrent_requests_coalesce(synth):
    counting = _Counting(synth)
    b = DynamicBatcher(counting, max_wait_ms=250.0)
    try:
        results = run_threads(
            lambda i: b.submit(TEXTS[i], SCALE, timeout=TIMEOUT), len(TEXTS))
        assert all("audio_pcm" in r for r in results)
        assert b.batches_run < len(TEXTS)
        assert b.requests_served == len(TEXTS)
        assert sum(c[0] for c in counting.calls) == len(TEXTS)
    finally:
        b.close()


def test_results_match_synthesize_batch_and_jax(synth, jax_synth):
    b = DynamicBatcher(synth, max_wait_ms=250.0)
    try:
        got = run_threads(
            lambda i: b.submit(TEXTS[i], SCALE, timeout=TIMEOUT), len(TEXTS))
    finally:
        b.close()
    direct = synth.synthesize_batch(TEXTS, SCALE)
    ref = jax_synth.synthesize_batch(TEXTS, SCALE)
    assert b.batches_run == 1  # one call of six: the direct call's shape
    for g, d, r in zip(got, direct, ref):
        assert g["frames"] == d["frames"] == r["frames"]
        np.testing.assert_array_equal(g["audio_pcm"], d["audio_pcm"])
        assert np.abs(g["audio_pcm"].astype(np.int32)
                      - r["audio_pcm"]).max(initial=0) <= 1


def test_groups_by_scale_and_format(synth):
    counting = _Counting(synth)
    b = DynamicBatcher(counting, max_wait_ms=250.0)
    jobs = [(TEXTS[i % 2], scale, fmt) for i in range(2)
            for scale in (4.0, SCALE) for fmt in ("int16", "mulaw")]
    try:
        got = run_threads(lambda i: b.submit(jobs[i][0], jobs[i][1],
                                             timeout=TIMEOUT,
                                             pcm_format=jobs[i][2]),
                          len(jobs))
    finally:
        b.close()
    assert {(s, f) for _, s, f in counting.calls} == \
        {(s, f) for _, s, f in jobs}
    assert sum(c[0] for c in counting.calls) == len(jobs)
    out = dict(zip(jobs, got))
    for text in TEXTS[:2]:
        for scale in (4.0, SCALE):
            r16, rmu = out[(text, scale, "int16")], out[(text, scale, "mulaw")]
            assert "audio_mulaw" not in r16
            np.testing.assert_array_equal(rmu["audio_mulaw"],
                                          mulaw_encode_np(r16["audio_pcm"]))
        assert len(out[(text, SCALE, "int16")]["audio_pcm"]) > \
            len(out[(text, 4.0, "int16")]["audio_pcm"])


def test_close_drains_then_rejects(synth):
    b = DynamicBatcher(synth, max_wait_ms=1000.0)
    results = [None] * 3

    def call(i):
        results[i] = b.submit(TEXTS[i], SCALE, timeout=TIMEOUT)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)  # the three are queued, the window still open
    finally:
        b.close()  # everything already queued still runs
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert all(r is not None for r in results)
    assert not b._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("too late", 1.0)
    b.close()  # idempotent


def test_failing_batch_fans_out_and_recovers(synth):
    class Boom(RuntimeError):
        pass

    class Flaky(_Counting):
        def synthesize_batch(self, texts, scale, **kw):
            if not self.calls:
                self.calls.append(len(texts))
                raise Boom("simulated device failure")
            return super().synthesize_batch(texts, scale, **kw)

    flaky = Flaky(synth)
    b = DynamicBatcher(flaky, max_wait_ms=300.0)
    try:
        def call(i):
            with pytest.raises(Boom):
                b.submit(TEXTS[i], SCALE, timeout=TIMEOUT)
            return True

        assert all(run_threads(call, 3))
        assert flaky.calls[0] == 3  # all three were in the failed batch
        assert len(b.submit(TEXTS[0], SCALE, timeout=TIMEOUT)["audio_pcm"])
    finally:
        b.close()


# -- StreamBatcher ------------------------------------------------------------

def solo(streamer, text, scale=SCALE):
    return np.concatenate(list(streamer.stream(text, scale)))


def _same(audio, ref, atol):
    assert audio.shape == ref.shape
    np.testing.assert_allclose(audio, ref, atol=atol, rtol=0)


def test_concurrent_streams_equal_solo_and_jax(streamer, jax_streamer):
    batcher = StreamBatcher(streamer, max_streams=4, max_wait_ms=200)
    try:
        got = run_threads(lambda i: np.concatenate(list(batcher.stream(
            STREAM_TEXTS[i], SCALE, timeout=TIMEOUT))), len(STREAM_TEXTS))
    finally:
        batcher.close()
    for text, audio in zip(STREAM_TEXTS, got):
        _same(audio, solo(streamer, text), 3e-5)
        _same(audio, solo(jax_streamer, text), 1e-5)


def test_dispatches_are_shared(streamer):
    batcher = StreamBatcher(streamer, max_streams=8, max_wait_ms=300)
    try:
        run_threads(lambda i: list(batcher.stream(STREAM_TEXTS[i], SCALE,
                                                  timeout=TIMEOUT)),
                    len(STREAM_TEXTS))
        assert batcher.streams_served == sum(
            len(streamer.split_long(t)) for t in STREAM_TEXTS)
        assert 0 < batcher.chunk_dispatches < batcher.chunks_emitted
    finally:
        batcher.close()


def test_short_utterance_path(streamer, jax_streamer):
    batcher = StreamBatcher(streamer, max_streams=4)
    try:
        chunks = list(batcher.stream("a", 4.0, timeout=TIMEOUT))
    finally:
        batcher.close()
    assert len(chunks) == 1 and batcher.chunks_emitted == 0
    _same(chunks[0], solo(streamer, "a", 4.0), 3e-5)
    _same(chunks[0], solo(jax_streamer, "a", 4.0), 1e-5)


def test_mixed_duration_scales(streamer, jax_streamer):
    batcher = StreamBatcher(streamer, max_streams=4, max_wait_ms=200)
    jobs = [("hello world", 4.0), ("hello world", 8.0),
            ("the quick brown fox", 6.0)]
    try:
        got = run_threads(lambda i: np.concatenate(list(batcher.stream(
            *jobs[i], timeout=TIMEOUT))), len(jobs))
    finally:
        batcher.close()
    for (text, scale), audio in zip(jobs, got):
        _same(audio, solo(streamer, text, scale), 3e-5)
        _same(audio, solo(jax_streamer, text, scale), 1e-5)


def test_long_text_through_batcher(streamer, jax_streamer):
    long_text = ("hello world again and again. " * 4).strip()
    assert len(streamer.split_long(long_text)) > 1
    batcher = StreamBatcher(streamer, max_streams=4, max_wait_ms=50)
    try:
        audio = np.concatenate(list(batcher.stream(long_text, SCALE,
                                                   timeout=TIMEOUT)))
    finally:
        batcher.close()
    assert batcher.streams_served == len(streamer.split_long(long_text))
    _same(audio, solo(streamer, long_text), 3e-5)
    _same(audio, solo(jax_streamer, long_text), 1e-5)


class _Spy:
    """Records the batch of every call of a function."""

    def __init__(self, fn):
        self.fn, self.inputs = fn, []

    def __call__(self, x, *args):
        self.inputs.append(x.clone())
        return self.fn(x, *args)


@pytest.mark.parametrize("cap,buckets", [(4, [1, 2, 4]), (6, [1, 2, 4, 6]),
                                         (16, [1, 2, 4, 8, 16])])
def test_warmup_runs_exactly_the_reachable_buckets(models, cap, buckets):
    st = StreamingSynthesizer(models[2], device="cpu", **STREAM_KW)
    st._acoustic = _Spy(st._acoustic)
    st.vocoder._run_chunk = _Spy(st.vocoder._run_chunk)
    batcher = StreamBatcher(st, max_streams=cap)
    try:
        assert batcher.reachable_buckets() == buckets
        assert batcher.warmup() == 2 * len(buckets)
    finally:
        batcher.close()
    assert [x.shape[0] for x in st._acoustic.inputs] == buckets
    assert [tuple(x.shape) for x in st.vocoder._run_chunk.inputs] == \
        [(b, st.vocoder._window, 16) for b in buckets]


def test_pad_slots_repeat_the_last_row(models):
    st = StreamingSynthesizer(models[2], device="cpu", **STREAM_KW)
    st._acoustic = _Spy(st._acoustic)
    st.vocoder._run_chunk = _Spy(st.vocoder._run_chunk)
    batcher = StreamBatcher(st, max_streams=4, max_wait_ms=300)
    texts = STREAM_TEXTS[:3]
    try:
        run_threads(lambda i: list(batcher.stream(texts[i], SCALE,
                                                  timeout=TIMEOUT)), 3)
    finally:
        batcher.close()
    ids = st._acoustic.inputs[0]
    assert ids.shape[0] == 4 and torch.equal(ids[3], ids[2])
    for x in st.vocoder._run_chunk.inputs:
        assert x.shape[0] in (1, 2, 4) and x.is_contiguous()
        if x.shape[0] == 4:
            assert torch.equal(x[3], x[2])


def test_closed_batcher_rejects(streamer):
    batcher = StreamBatcher(streamer)
    batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.stream("too late")
    batcher.close()  # idempotent
    assert not batcher._admitter.is_alive()
    assert not batcher._scheduler.is_alive()


def test_churn_staggered_arrivals(streamer):
    """More streams than the batch cap and the cores, staggered arrivals,
    mixed lengths and scales, with frequent thread switches: every stream
    equals its solo stream, no chunk or stream is lost from the counters,
    and the batcher drains clean."""
    jobs = [(STREAM_TEXTS[i % len(STREAM_TEXTS)], 4.0 + (i % 3) * 2.0)
            for i in range(10)]
    batcher = StreamBatcher(streamer, max_streams=4, max_wait_ms=20)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(i):
            time.sleep(0.015 * i)
            return list(batcher.stream(*jobs[i], timeout=TIMEOUT))

        got = run_threads(run, len(jobs))
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
    for (text, scale), chunks in zip(jobs, got):
        _same(np.concatenate(chunks), solo(streamer, text, scale), 3e-5)
    sentences = [(s, scale) for text, scale in jobs
                 for s in streamer.split_long(text)]
    assert batcher.streams_served == len(sentences) > len(jobs)
    # a stream longer than one window has two chunks or more; a one-chunk
    # stream took the short path, which emits no batched chunk
    solo_counts = [len(list(streamer.stream(*job))) for job in sentences]
    assert batcher.chunks_emitted == sum(n for n in solo_counts if n > 1)
    assert len(batcher._active) == 0
