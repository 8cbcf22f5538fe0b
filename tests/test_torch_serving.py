"""Synthesizer of the PyTorch port against the JAX one, on the CPU in f32:
the same weights, texts, buckets and duration scale give the same frame
bucket and frame counts and int16 PCM within ±1 LSB; the μ-law codec, the
text frontend and the long-form split agree exactly."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.frontend import text as jtext
from m2tts_tpu.models import M2TTS as JaxM2TTS
from m2tts_tpu.ops import audio_codec as jcodec
from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer
from m2tts_tpu_torch.frontend import text as ttext
from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.ops import audio_codec as tcodec
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.serving.pipeline import Synthesizer
from m2tts_tpu_torch.utils.params import from_flax

from host_formulas import host_formulas, same_results

torch.set_num_threads(2)

KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
               batch_buckets=(1, 2, 4))
TEXTS = ["hello world", "the quick brown fox jumps", "a"]
SCALE = 12.0  # random-init durations are ~0.3 frames; scale them up


def _flax_params(seed):
    model = JaxM2TTS(**KW)
    params = jax.device_get(jax.jit(partial(
        model.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    return model, params


@pytest.fixture(scope="module")
def pair():
    jm, params = _flax_params(0)
    tm = M2TTS(**KW)
    tm.load_state_dict(from_flax(params), strict=True)
    js = JaxSynthesizer(jm, params, **BUCKETS)
    ts = Synthesizer(tm, device="cpu", **BUCKETS)
    assert ts.vocoder_backend == "torch" and ts.compute_dtype == "f32"
    return js, ts


def _assert_pcm_close(a, b):
    assert a.shape == b.shape
    if a.size:
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("scale", [1.0, SCALE])
def test_buckets_frames_and_pcm_match(pair, scale):
    js, ts = pair
    j_out, j_frames = js._launch(TEXTS, scale, None, False)
    t_out, t_frames = ts._launch(TEXTS, scale, None, False)
    assert j_frames == t_frames  # same frame bucket
    ref = js._collect(j_out, j_frames, len(TEXTS), False)
    out = ts._collect(t_out, t_frames, len(TEXTS), False)
    for r, o in zip(ref, out):
        assert r["frames"] == o["frames"]
        assert r.get("truncated") == o.get("truncated")
        _assert_pcm_close(r["audio_pcm"], o["audio_pcm"])


def test_truncated_flag_matches(pair):
    js, ts = pair
    text = ["the quick brown fox jumps over the lazy dog again and again"]
    ref = js.synthesize_batch(text, duration_scale=40.0)
    out = ts.synthesize_batch(text, duration_scale=40.0)
    assert ref[0].get("truncated") and out[0].get("truncated")
    assert ref[0]["frames"] == out[0]["frames"] == 128
    _assert_pcm_close(ref[0]["audio_pcm"], out[0]["audio_pcm"])


@pytest.mark.parametrize("backend", ["mm"])
def test_packed_backend_matches_torch(pair, backend):
    js, ts = pair
    mm = Synthesizer(ts.model, device="cpu", vocoder_backend=backend,
                     **BUCKETS)
    for r, o in zip(ts.synthesize_batch(TEXTS, SCALE),
                    mm.synthesize_batch(TEXTS, SCALE)):
        assert r["frames"] == o["frames"]
        _assert_pcm_close(r["audio_pcm"], o["audio_pcm"])


def test_mulaw_encoder_exact_on_all_codes():
    codes = np.arange(-32768, 32768, dtype=np.int16)
    ref = np.asarray(jcodec.mulaw_encode_pcm16(jnp.asarray(codes)))
    out = tcodec.mulaw_encode_pcm16(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(tcodec.mulaw_encode_np(codes), ref)
    np.testing.assert_array_equal(tcodec.MULAW_DECODE_TABLE,
                                  jcodec.MULAW_DECODE_TABLE)


def test_mulaw_output_is_encode_of_int16(pair):
    _, ts = pair
    pcm = ts.synthesize_batch(TEXTS, SCALE)
    mu = ts.synthesize_batch(TEXTS, SCALE, pcm_format="mulaw")
    for p, m in zip(pcm, mu):
        np.testing.assert_array_equal(m["audio_mulaw"],
                                      tcodec.mulaw_encode_np(p["audio_pcm"]))
        np.testing.assert_array_equal(
            m["audio_pcm"], tcodec.mulaw_decode_np(m["audio_mulaw"]))
    with pytest.raises(ValueError):
        ts.synthesize_batch(TEXTS, pcm_format="alaw")


def test_frontend_ids_match():
    tj, tt = jtext.TextProcessor(), ttext.TextProcessor()
    texts = TEXTS + ["Dr. Smith, 12 cats & 3 dogs!", "xylophone qi"]
    bj, bt = tj.batch(texts, 24), tt.batch(texts, 24)
    np.testing.assert_array_equal(bj["phoneme_ids"], bt["phoneme_ids"])
    np.testing.assert_array_equal(bj["lengths"], bt["lengths"])


def test_split_text_and_long_form_match(pair):
    js, ts = pair
    long = ("Hello world. " * 3 + "This is a much longer sentence, with a "
            "comma, that needs splitting into pieces to fit the budget. "
            "The end!")
    assert js.split_text(long) == ts.split_text(long)
    ref = js.synthesize_batch_long([long, "hello"], SCALE)
    out = ts.synthesize_batch_long([long, "hello"], SCALE)
    for r, o in zip(ref, out):
        assert r["chunks"] == o["chunks"]
        assert r["frames"] == o["frames"]
        assert r.get("truncated") == o.get("truncated")
        _assert_pcm_close(r["audio_pcm"], o["audio_pcm"])


@pytest.mark.parametrize("text", [
    "Hello world. " * 3 + "This is a much longer sentence, with a comma, "
    "that needs splitting into pieces to fit the budget. The end!",
    "hello world"], ids=["over-budget", "in-budget"])
def test_synthesize_long_matches_jax(pair, text):
    js, ts = pair
    ref = js.synthesize_long(text, SCALE)
    out = ts.synthesize_long(text, SCALE)
    assert out["chunks"] == ref["chunks"] == ts.split_text(text)
    assert (len(out["chunks"]) > 1) == (text != "hello world")
    assert out["frames"] == ref["frames"]
    assert out.get("truncated") == ref.get("truncated")
    _assert_pcm_close(ref["audio_pcm"], out["audio_pcm"])


def test_stream_matches_batch(pair):
    _, ts = pair
    batches = [["hello"], ["hello world"], ["the world"]]
    streamed = list(ts.synthesize_stream(iter(batches), SCALE))
    for s, b in zip(streamed, batches):
        np.testing.assert_array_equal(
            s[0]["audio_pcm"], ts.synthesize_batch(b, SCALE)[0]["audio_pcm"])


def test_swap_params_serves_new_weights():
    jm, params0 = _flax_params(0)
    _, params1 = _flax_params(1)
    tm = M2TTS(**KW)
    tm.load_state_dict(from_flax(params0))
    ts = Synthesizer(tm, device="cpu", vocoder_backend="mm", **BUCKETS)
    before = ts.synthesize_batch(TEXTS, SCALE)
    ts.swap_params(from_flax(params1))
    after = ts.synthesize_batch(TEXTS, SCALE)
    ref = JaxSynthesizer(jm, params1, **BUCKETS).synthesize_batch(TEXTS, SCALE)
    assert any(a["frames"] != b["frames"]
               or not np.array_equal(a["audio_pcm"], b["audio_pcm"])
               for a, b in zip(after, before))
    for r, o in zip(ref, after):
        assert r["frames"] == o["frames"]
        _assert_pcm_close(r["audio_pcm"], o["audio_pcm"])
    bad = from_flax(params1)
    bad.pop("vocoder.output_conv.conv.bias")
    with pytest.raises(ValueError):
        ts.swap_params(bad)


def test_bf16_close_to_f32(pair):
    _, ts = pair
    s16 = Synthesizer(ts.model, device="cpu", compute_dtype="bf16", **BUCKETS)
    a = ts.synthesize_batch(TEXTS, SCALE)
    b = s16.synthesize_batch(TEXTS, SCALE)
    for x, y in zip(a, b):
        # the probe is f32 in both, so the bucket agrees; bf16 durations
        # may move a frame count by one near a floor boundary
        assert abs(x["frames"] - y["frames"]) <= max(2, x["frames"] // 50)
        assert np.isfinite(y["audio"]).all()


def test_warmup_runs_every_shape(pair):
    _, ts = pair
    assert ts.warmup(full=False) == len(ts.text_buckets) * len(ts.frame_buckets)


def test_from_config_on_cpu():
    synth = pipeline.from_config({"model": {
        "text_encoder": {"hidden_dim": 16, "num_layers": 1},
        "decoder": {"mel_channels": 8, "num_layers": 1},
        "vocoder": {"hidden_channels": 16, "upsample_rates": [2, 2]}}},
        device="cpu", **BUCKETS)
    res = synth.synthesize("hello world", duration_scale=SCALE)
    assert res["audio_pcm"].dtype == np.int16
    assert res["audio"].shape == (res["frames"] * 4,)


# -- outputs made on the device, fetched to the host, sliced there ----------

#: the last text passes the largest frame bucket at SCALE, so a row is cut
HOST_TEXTS = TEXTS + ["the quick brown fox jumps over the lazy dog again "
                      "and again"]


@pytest.mark.parametrize("want_mel", [False, True], ids=["pcm", "mel"])
@pytest.mark.parametrize("pcm_format", ["int16", "mulaw"])
def test_device_outputs_equal_the_host_formulas(pair, pcm_format, want_mel):
    """The results ``_stage`` made on the device and ``_unpack`` sliced
    against the old host formulas on the same launch's outputs; and the
    float32 and decoded int16 against those formulas on the returned
    bytes."""
    ts = pair[1]
    out, frames = ts._launch(HOST_TEXTS, SCALE, None, want_mel, pcm_format)
    want = host_formulas(ts, out, frames, len(HOST_TEXTS), want_mel, False)
    got = ts._collect(out, frames, len(HOST_TEXTS), want_mel)
    assert any(r.get("truncated") for r in got)  # the case's premise
    assert not all(r.get("truncated") for r in got)
    same_results(got, want)
    for r in got:
        if pcm_format == "mulaw":
            assert r["audio_pcm"].tobytes() == tcodec.mulaw_decode_np(
                r["audio_mulaw"]).tobytes()
        assert r["audio"].tobytes() == (
            r["audio_pcm"].astype(np.float32) / 32767.0).tobytes()
    batch = ts.synthesize_batch(HOST_TEXTS, SCALE, want_mel=want_mel,
                                pcm_format=pcm_format)
    same_results(batch, want)


@pytest.mark.parametrize("pcm_format", ["int16", "mulaw"])
def test_stream_pcm_only_makes_no_float32(pair, pcm_format):
    """``synthesize_stream(pcm_only=True)``: no ``audio`` (nor, under
    μ-law, ``audio_pcm``); the PCM as the batch path gives it."""
    ts = pair[1]
    batches = [HOST_TEXTS[:2], HOST_TEXTS[2:]]
    streamed = list(ts.synthesize_stream(iter(batches), SCALE,
                                         pcm_only=True,
                                         pcm_format=pcm_format))
    key = "audio_mulaw" if pcm_format == "mulaw" else "audio_pcm"
    for got, texts in zip(streamed, batches):
        want = ts.synthesize_batch(texts, SCALE, pcm_format=pcm_format)
        for g, w in zip(got, want):
            assert "audio" not in g
            assert ("audio_pcm" in g) is (pcm_format == "int16")
            assert g[key].tobytes() == w[key].tobytes()
            assert (g["frames"], g.get("truncated")) == \
                (w["frames"], w.get("truncated"))


def test_results_survive_the_next_call(pair):
    """A call's arrays, views of its own host outputs, keep their bytes
    through a later call on other texts in the same buckets."""
    ts = pair[1]
    first = ts.synthesize_batch(HOST_TEXTS, SCALE, want_mel=True)
    kept = [{k: v.copy() for k, v in r.items()
             if isinstance(v, np.ndarray)} for r in first]
    ts.synthesize_batch(["a different text", "other words here", "b",
                         "yet another sentence to say aloud now"],
                        SCALE, want_mel=True)
    for r, k in zip(first, kept):
        for name, v in k.items():
            assert r[name].tobytes() == v.tobytes(), name


def test_conversion_is_exact_on_every_code(pair):
    """``_stage`` over all 65,536 int16 codes and all 256 μ-law bytes
    against numpy's ``astype(np.float32) / 32767.0`` and the decode
    table; off CUDA nothing goes through the pinned copy."""
    ts = pair[1]
    codes = np.arange(-32768, 32768).astype(np.int16)
    for pcm, decoded in ((codes, codes),
                         (np.arange(256, dtype=np.uint8),
                          tcodec.MULAW_DECODE_TABLE)):
        out = pipeline._Launched(
            pcm=torch.from_numpy(pcm.copy())[None],
            total_frames=torch.zeros(1, dtype=torch.int32))
        ts._stage(out, pcm_only=False)
        host = ts._fetch(out)
        if pcm.dtype == np.uint8:
            assert host["audio_pcm"][0].tobytes() == decoded.tobytes()
        assert host["audio"][0].tobytes() == (
            decoded.astype(np.float32) / 32767.0).tobytes()
    assert (ts.pinned_fetches, ts.fetched_bytes) == (0, 0)


def test_kept_results_hold_only_their_own_rows(pair):
    """``own_rows`` and ``synthesize_batch_long`` (which keeps every call's
    results until the join) leave each array its own trimmed bytes, none a
    view of a call's padded outputs."""
    ts = pair[1]
    rows = pipeline.own_rows(ts.synthesize_batch(HOST_TEXTS, SCALE,
                                                 want_mel=True))
    same_results(rows, ts.synthesize_batch(HOST_TEXTS, SCALE, want_mel=True))
    long = " ".join(["the quick brown fox jumps over the lazy dog."] * 3)
    for r in rows + ts.synthesize_batch_long([long, "hello"], SCALE):
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert v.base is None and v.flags.owndata, k
