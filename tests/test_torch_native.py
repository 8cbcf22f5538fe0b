"""The PyTorch port's loader of the C++ mel frontend
(``frontend/native.py``), which builds ``native/mel_frontend.cpp`` into
``build/native/``: its mel against the port's NumPy mel and against the
JAX package's NumPy mel, ``compute_mel_spectrogram`` (atol 2e-5, the bar
at which ``tests/test_native_frontend.py`` holds the JAX package's own
native mel to that NumPy mel); ``compute_mel_batch`` equal to one
call at a time; ``AudioProcessor(use_native=...)`` with the JAX
semantics ('auto' falls back to NumPy when the build fails, True raises,
False never tries). Needs ``g++``."""

import shutil

import numpy as np
import pytest
import torch

from m2tts_tpu.frontend import audio as jaudio
from m2tts_tpu_torch.frontend import audio as taudio
from m2tts_tpu_torch.frontend import native

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler")

ATOL = 2e-5
NONDEFAULT = dict(sample_rate=16000, n_fft=512, hop_length=128,
                  win_length=400, n_mels=80, fmin=30.0, fmax=7600.0)


def _audio(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3) \
        .astype(np.float32)


def test_builds_into_build_dir():
    assert native.native_available()
    lib = native.lib_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib.parent.parent.name == "build"


@pytest.mark.parametrize("n_samples,kw", [
    (2048, {}), (22050, {}), (66150, {}), (32000, NONDEFAULT),
], ids=["2048", "22050", "66150", "nondefault"])
def test_mel_matches_numpy_and_jax(n_samples, kw):
    audio = _audio(n_samples, seed=n_samples)
    got = native.compute_mel_native(audio, **kw)
    ap = taudio.AudioProcessor(use_native=False, **kw)
    ref = ap.compute_mel(audio)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        got, jaudio.compute_mel_spectrogram(audio, **kw), rtol=0, atol=ATOL)


def test_processor_takes_the_native_path():
    ap = taudio.AudioProcessor(use_native=True, n_mels=80)
    assert ap._native is native
    audio = _audio(11025, seed=7)
    np.testing.assert_array_equal(
        ap.compute_mel(audio),
        native.compute_mel_native(audio, n_mels=80, fmax=11025.0))
    assert taudio.AudioProcessor(use_native=False)._native is None


def test_short_audio_takes_the_numpy_path():
    audio = _audio(400, seed=8)
    with pytest.raises(ValueError):
        native.compute_mel_native(audio)
    np.testing.assert_array_equal(
        taudio.AudioProcessor(use_native=True).compute_mel(audio),
        taudio.AudioProcessor(use_native=False).compute_mel(audio))


@pytest.mark.parametrize("n_threads", [0, 1, 4])
def test_batch_equals_one_by_one(n_threads):
    audios = [_audio(n, seed=i) for i, n in
              enumerate([4096, 8192, 22050, 5000, 3000])]
    batch = native.compute_mel_batch(audios, n_threads=n_threads)
    assert len(batch) == len(audios)
    for a, b in zip(audios, batch):
        np.testing.assert_array_equal(b, native.compute_mel_native(a))


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """A fresh loader whose compile fails (an unknown g++ flag) into an
    empty build dir."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX_FLAGS", ["--no-such-flag"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)


def test_failed_build(broken_build, caplog):
    assert not native.build_native()
    assert not native.native_available()
    assert "build failed" in caplog.text
    with pytest.raises(RuntimeError):
        taudio.AudioProcessor(use_native=True)
    with pytest.raises(RuntimeError):
        native.compute_mel_native(_audio(4096))
    auto = taudio.AudioProcessor(use_native="auto")
    assert auto._native is None
    audio = _audio(4096, seed=9)
    np.testing.assert_array_equal(
        auto.compute_mel(audio),
        taudio.AudioProcessor(use_native=False).compute_mel(audio))
