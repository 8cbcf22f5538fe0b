"""Streaming of the PyTorch port against the JAX package's, on the CPU in
f32: the same weights (carried with ``from_flax``) and the same mel or
text, made from a numpy seed, give the same chunk count and chunk lengths
exactly and audio within atol 1e-5 (the port's 'torch' backend against JAX
'xla', 'mm' against 'mm'). The port's streamed output equals its own whole
vocoder within atol 2e-6 over many chunks, a partial last chunk and a
single chunk, as ``tests/test_streaming.py`` holds the JAX package."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import M2TTS as JaxM2TTS
from m2tts_tpu.serving import streaming as jstreaming
from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.ops.vocoder_mm import (pack_vocoder_weights,
                                            vocoder_mm_forward)
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.serving.streaming import (StreamingSynthesizer,
                                               StreamingVocoder)
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
JAX_TOL = dict(atol=1e-5, rtol=0)
SELF_TOL = dict(atol=2e-6, rtol=0)
BF16_MAX, BF16_MEAN = 1.5e-2, 2e-3


@pytest.fixture(scope="module", params=[(4, 4, 2, 2), (8, 8, 2, 2)],
                ids=["64x", "256x"])
def pair(request):
    jm = JaxM2TTS(upsample_rates=request.param, **KW)
    params = jax.device_get(jax.jit(partial(
        jm.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tm = M2TTS(upsample_rates=request.param, **KW)
    tm.load_state_dict(from_flax(params), strict=True)
    return jm, params, tm.eval()


def _mel(T, seed=0):
    return np.random.default_rng(seed).normal(size=(T, 16)).astype(np.float32)


def _full(tm, mel, backend="torch"):
    """The whole mel through one call of ``backend`` in f32."""
    x = torch.from_numpy(mel)[None]
    with torch.no_grad():
        if backend == "mm":
            return vocoder_mm_forward(
                x, pack_vocoder_weights(tm.vocoder, "f32"), "f32")[0].numpy()
        return tm.vocoder(x)[0, :, 0].numpy()


def _assert_same_chunks(ours, ref, tol):
    assert [len(c) for c in ours] == [len(c) for c in ref]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, np.asarray(r), **tol)


@pytest.mark.parametrize("T", [100, 45, 10], ids=["many", "partial", "one"])
@pytest.mark.parametrize("backends", [("torch", "xla"), ("mm", "mm")],
                         ids=["torch-xla", "mm-mm"])
def test_vocoder_stream_matches_jax(pair, backends, T):
    jm, params, tm = pair
    ours_b, jax_b = backends
    mel = _mel(T)
    ref = list(jstreaming.StreamingVocoder(
        jm, params, chunk_frames=32, vocoder_backend=jax_b).stream(mel))
    ours = list(StreamingVocoder(tm, chunk_frames=32, vocoder_backend=ours_b,
                                 device="cpu").stream(mel))
    _assert_same_chunks(ours, ref, JAX_TOL)


@pytest.mark.parametrize("T,lengths", [(100, [32, 32, 32, 4]),
                                       (45, [32, 13]), (10, [10])],
                         ids=["many", "partial", "one"])
@pytest.mark.parametrize("backend", ["torch", "mm"])
def test_stream_equals_whole(pair, backend, T, lengths):
    _, _, tm = pair
    mel = _mel(T, seed=1)
    sv = StreamingVocoder(tm, chunk_frames=32, vocoder_backend=backend,
                          device="cpu")
    chunks = list(sv.stream(mel))
    assert [len(c) for c in chunks] == [n * sv.upsample for n in lengths]
    whole = _full(tm, mel, backend)
    np.testing.assert_allclose(np.concatenate(chunks), whole, **SELF_TOL)
    np.testing.assert_allclose(sv.synthesize(mel), whole, **SELF_TOL)


def test_auto_resolves_to_torch_f32_on_cpu(pair):
    sv = StreamingVocoder(pair[2], device="cpu")
    assert (sv.vocoder_backend, sv.compute_dtype) == ("torch", "f32")
    assert sv._window == 64 + 2 * 4


@pytest.mark.parametrize("T", [50, 64])
def test_stream_device_equals_stream(pair, T):
    _, _, tm = pair
    sv = StreamingVocoder(tm, chunk_frames=16, device="cpu")
    padded = torch.from_numpy(_mel(64, seed=2))
    dev = list(sv.stream_device(padded[None], T))
    host = list(sv.stream(padded.numpy(), T))
    assert [len(c) for c in dev] == [len(c) for c in host]
    for d, h in zip(dev, host):
        np.testing.assert_array_equal(d, h)
    tail = list(sv.stream_device(padded[None], T, start_chunk=1))
    assert len(tail) == len(host) - 1
    np.testing.assert_array_equal(np.concatenate(tail),
                                  np.concatenate(host[1:]))


@pytest.mark.parametrize("backend", ["torch", "mm"])
def test_short_path_equals_whole(pair, backend):
    """T ≤ window: one f32 call on the whole mel, even in a bf16 stream."""
    _, _, tm = pair
    for cd in ("f32", "bf16"):
        sv = StreamingVocoder(tm, chunk_frames=16, vocoder_backend=backend,
                              compute_dtype=cd, device="cpu")
        T = sv._window - 2
        padded = torch.from_numpy(_mel(64, seed=3))
        chunks = list(sv.stream_device(padded[None], T))
        assert len(chunks) == 1
        np.testing.assert_allclose(
            chunks[0], _full(tm, padded.numpy()[:T], backend), **SELF_TOL)
    empty = list(sv.stream(_mel(0)))
    assert len(empty) == 1 and empty[0].shape == (0,)


def test_short_path_matches_jax(pair):
    jm, params, tm = pair
    mel = _mel(20, seed=4)
    ref = list(jstreaming.StreamingVocoder(jm, params, chunk_frames=16)
               .stream(mel))
    ours = list(StreamingVocoder(tm, chunk_frames=16, device="cpu")
                .stream(mel))
    _assert_same_chunks(ours, ref, JAX_TOL)


def test_bf16_stream_close_to_whole(pair):
    _, _, tm = pair
    mel = _mel(100, seed=5)
    whole = vocoder_mm_forward(torch.from_numpy(mel)[None],
                               pack_vocoder_weights(tm.vocoder, "bf16"),
                               "bf16")[0].numpy()
    sv = StreamingVocoder(tm, chunk_frames=32, vocoder_backend="mm",
                          compute_dtype="bf16", device="cpu")
    err = np.abs(sv.synthesize(mel) - whole)
    assert err.max() < BF16_MAX and err.mean() < BF16_MEAN


@pytest.mark.parametrize("backends", [("torch", "xla"), ("mm", "mm")],
                         ids=["torch-xla", "mm-mm"])
def test_streaming_synthesizer_matches_jax(pair, backends):
    jm, params, tm = pair
    ours_b, jax_b = backends
    kw = dict(chunk_frames=16, max_frames=64, text_bucket=32)
    ref = list(jstreaming.StreamingSynthesizer(
        jm, params, vocoder_backend=jax_b, **kw)
        .stream("hello streaming world", 8.0))
    ss = StreamingSynthesizer(tm, vocoder_backend=ours_b, device="cpu", **kw)
    assert ss._fuse_first
    ours = list(ss.stream("hello streaming world", 8.0))
    assert len(ours) >= 3  # frames > window: the fused first chunk ran
    _assert_same_chunks(ours, ref, JAX_TOL)


def test_fused_first_chunk_matches_unfused(pair):
    _, _, tm = pair
    kw = dict(chunk_frames=16, max_frames=64, text_bucket=32, device="cpu")
    fused = list(StreamingSynthesizer(tm, **kw)
                 .stream("hello streaming world", 8.0))
    assert len(fused) >= 3
    unfused_ss = StreamingSynthesizer(tm, **kw)
    unfused_ss._fuse_first = False
    unfused = list(unfused_ss.stream("hello streaming world", 8.0))
    _assert_same_chunks(fused, unfused, SELF_TOL)
    # a max_frames below one window cannot fuse
    assert not StreamingSynthesizer(tm, chunk_frames=16, max_frames=16,
                                    text_bucket=32, device="cpu")._fuse_first


def test_short_utterance_through_synthesizer(pair):
    """frames ≤ window after the fused pass: the whole-mel path."""
    jm, params, tm = pair
    kw = dict(chunk_frames=16, max_frames=64, text_bucket=32)
    ref = list(jstreaming.StreamingSynthesizer(jm, params, **kw)
               .stream("hi", 8.0))
    ours = list(StreamingSynthesizer(tm, device="cpu", **kw).stream("hi", 8.0))
    assert len(ours) == 1
    _assert_same_chunks(ours, ref, JAX_TOL)


def test_long_text_split_matches_jax(pair):
    jm, params, tm = pair
    kw = dict(chunk_frames=16, max_frames=64, text_bucket=16,
              sample_rate=1000)
    long_text = "one two three. four five six. seven eight nine."
    jss = jstreaming.StreamingSynthesizer(jm, params, **kw)
    ss = StreamingSynthesizer(tm, device="cpu", **kw)
    chunks = ss.split_long(long_text)
    assert chunks == jss.split_long(long_text) and len(chunks) > 1
    assert ss.split_long("short one") == ["short one"]
    np.testing.assert_array_equal(ss.gap(120.0), jss.gap(120.0))
    ours = list(ss.stream(long_text, 4.0))
    _assert_same_chunks(ours, list(jss.stream(long_text, 4.0)), JAX_TOL)
    expected = []
    for i, c in enumerate(chunks):
        if i:
            expected.append(ss.gap(120.0))
        expected.extend(ss.stream(c, 4.0))
    _assert_same_chunks(ours, expected, SELF_TOL)


def test_bf16_streaming_synthesizer_runs(pair):
    _, _, tm = pair
    kw = dict(chunk_frames=16, max_frames=64, text_bucket=32, device="cpu")
    f32 = np.concatenate(list(StreamingSynthesizer(tm, **kw)
                              .stream("hello streaming world", 8.0)))
    for backend in ("torch", "mm"):
        ss = StreamingSynthesizer(tm, vocoder_backend=backend,
                                  compute_dtype="bf16", **kw)
        assert ss._acoustic_model is not tm
        b16 = np.concatenate(list(ss.stream("hello streaming world", 8.0)))
        assert np.isfinite(b16).all()
        # the durations run in bf16 here, so a frame count may move by one
        assert abs(len(b16) - len(f32)) <= 2 * ss.vocoder.upsample


def test_unknown_backend_or_dtype_raises(pair):
    tm = pair[2]
    with pytest.raises(ValueError, match="vocoder_backend"):
        StreamingVocoder(tm, vocoder_backend="magic", device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        StreamingVocoder(tm, compute_dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="vocoder_backend"):
        pipeline.make_vocoder_fn(tm, "torch", "f32")
    with pytest.raises(ValueError, match="CUDA"):
        pipeline.make_vocoder_fn(tm, "cuda", "f32")


def test_streaming_default_device_is_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        StreamingVocoder(pair[2])
    with pytest.raises(RuntimeError):
        StreamingSynthesizer(pair[2])
