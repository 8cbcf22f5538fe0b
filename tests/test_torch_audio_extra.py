"""Griffin-Lim of the PyTorch port (``frontend/audio.py``: ``istft``,
``db_to_power``, ``griffin_lim``, ``mel_to_audio`` and
``AudioProcessor.mel_to_audio``) against the JAX package's functions, on
seeded inputs made with numpy. Both are NumPy code on the host in f64
with an f32 result, so they agree within 1e-6 (atol); ``db_to_power``
exactly."""

import numpy as np
import pytest
import torch

from m2tts_tpu.frontend import audio as jaudio
from m2tts_tpu_torch.frontend import audio as taudio

torch.set_num_threads(2)

ATOL = 1e-6


def _spec(n_fft, frames, seed):
    rng = np.random.default_rng(seed)
    shape = (n_fft // 2 + 1, frames)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _mel(n_mels, frames, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((n_mels, frames)) * 0.4, -1, 1) \
        .astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,win,center,length", [
    (1024, 256, None, True, None),
    (512, 128, 400, True, 3000),
    (256, 64, None, False, None),
], ids=["default", "win400_length", "uncentered"])
def test_istft_matches_jax(n_fft, hop, win, center, length):
    spec = _spec(n_fft, 12, 0)
    ref = jaudio.istft(spec, hop, win, center, length)
    out = taudio.istft(spec, hop, win, center, length)
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_istft_inverts_stft():
    audio = np.random.default_rng(1).standard_normal(4096)
    spec = taudio.stft(audio, 1024, 256)
    back = taudio.istft(spec, 256, length=len(audio))
    np.testing.assert_allclose(back, audio, rtol=0, atol=1e-5)


def test_db_to_power_matches_jax():
    db = np.linspace(-80.0, 10.0, 37)
    np.testing.assert_array_equal(taudio.db_to_power(db, 2.0),
                                  jaudio.db_to_power(db, 2.0))


@pytest.mark.parametrize("n_iter,momentum", [(4, 0.99), (8, 0.0)])
def test_griffin_lim_matches_jax(n_iter, momentum):
    mag = np.abs(_spec(512, 20, 2))
    ref = jaudio.griffin_lim(mag, n_iter, 128, None, momentum)
    out = taudio.griffin_lim(mag, n_iter, 128, None, momentum)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("reference_denorm", [True, False])
def test_mel_to_audio_matches_jax(reference_denorm):
    mel = _mel(16, 24, 3)
    kw = dict(sample_rate=16000, n_fft=512, hop_length=128, win_length=512,
              n_iter=6, reference_denorm=reference_denorm)
    ref = jaudio.mel_to_audio(mel, **kw)
    out = taudio.mel_to_audio(mel, **kw)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out).max() == pytest.approx(1.0)  # peak-normalised
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_mels,n_iter", [(16, 32), (64, 4)])
def test_audio_processor_mel_to_audio_matches_jax(n_mels, n_iter):
    mel = _mel(n_mels, 30, 4)
    ref = jaudio.AudioProcessor(n_mels=n_mels, use_native=False) \
        .mel_to_audio(mel, n_iter)
    out = taudio.AudioProcessor(n_mels=n_mels, use_native=False) \
        .mel_to_audio(mel, n_iter)
    assert out.shape == ref.shape == ((30 - 1) * 256,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
