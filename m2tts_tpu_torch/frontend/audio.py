"""Host-side audio DSP frontend (NumPy + stdlib WAV IO).

A copy of ``m2tts_tpu/frontend/audio.py``: WAV IO, the centred STFT
(reflect padding, periodic Hann, ``win_length`` zero-padded to ``n_fft``)
and its overlap-add inverse, the Slaney mel filterbank, ``power_to_db``
(ref = max, top_db 80) and the per-utterance min-max normalisation to
[-1, 1] that ``AudioProcessor.compute_mel`` applies (the model's training
target), and the Griffin-Lim inversion of a mel (``mel_to_audio``), which
runs on the host as in the JAX package. ``AudioProcessor(use_native=...)``
takes the C++ mel frontend (``frontend/native.py``) with the JAX
package's semantics.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

DEFAULT_SAMPLE_RATE = 22050
DEFAULT_N_FFT = 1024
DEFAULT_HOP = 256
DEFAULT_WIN = 1024
DEFAULT_N_MELS = 64


# ---------------------------------------------------------------------------
# WAV IO (stdlib `wave`; LJSpeech is 16-bit PCM)
# ---------------------------------------------------------------------------

def load_wav(path: Union[str, Path], sample_rate: int = DEFAULT_SAMPLE_RATE,
             normalize: bool = True) -> Tuple[np.ndarray, int]:
    """Load a PCM WAV as float32 mono in [-1, 1], resampling if needed."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if sampwidth == 2:
        audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        audio = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        audio = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels).mean(axis=1)
    if sr != sample_rate:
        audio = resample(audio, sr, sample_rate)
        sr = sample_rate
    if normalize:
        peak = np.max(np.abs(audio))
        if peak > 0:
            audio = audio / peak
    return audio.astype(np.float32), sr


def save_wav(audio: np.ndarray, path: Union[str, Path],
             sample_rate: int = DEFAULT_SAMPLE_RATE) -> None:
    """Write float32 audio in [-1, 1] as 16-bit PCM WAV."""
    audio = np.asarray(audio).squeeze()
    if audio.ndim != 1:
        audio = audio.reshape(-1)
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling via scipy (host preprocessing only)."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


# ---------------------------------------------------------------------------
# STFT
# ---------------------------------------------------------------------------

def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (fftbins=True convention)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def _pad_center(window: np.ndarray, size: int) -> np.ndarray:
    lpad = (size - len(window)) // 2
    return np.pad(window, (lpad, size - len(window) - lpad))


def frame_signal(audio: np.ndarray, n_fft: int, hop_length: int,
                 center: bool = True) -> np.ndarray:
    """Slice audio into [n_frames, n_fft] frames (reflect-padded if centered)."""
    if center:
        audio = np.pad(audio, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(audio) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    return audio[idx]


def stft(audio: np.ndarray, n_fft: int = DEFAULT_N_FFT,
         hop_length: int = DEFAULT_HOP, win_length: Optional[int] = None,
         center: bool = True) -> np.ndarray:
    """Complex STFT, shape [1 + n_fft//2, n_frames] (librosa layout)."""
    win_length = win_length or n_fft
    window = _pad_center(hann_window(win_length), n_fft)
    frames = frame_signal(np.asarray(audio, dtype=np.float64), n_fft, hop_length, center)
    return np.fft.rfft(frames * window, n=n_fft, axis=1).T


def istft(spec: np.ndarray, hop_length: int = DEFAULT_HOP,
          win_length: Optional[int] = None, center: bool = True,
          length: Optional[int] = None) -> np.ndarray:
    """Inverse STFT with window-sum-squared normalization (overlap-add)."""
    n_fft = 2 * (spec.shape[0] - 1)
    win_length = win_length or n_fft
    window = _pad_center(hann_window(win_length), n_fft)
    frames = np.fft.irfft(spec.T, n=n_fft, axis=1) * window
    n_frames = frames.shape[0]
    out_len = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(out_len)
    wsum = np.zeros(out_len)
    w2 = window**2
    for i in range(n_frames):
        start = i * hop_length
        out[start:start + n_fft] += frames[i]
        wsum[start:start + n_fft] += w2
    out = np.where(wsum > 1e-11, out / np.maximum(wsum, 1e-11), out)
    if center:
        out = out[n_fft // 2:]
    if length is not None:
        out = np.pad(out[:length], (0, max(0, length - len(out))))
    else:
        out = out[: out_len - n_fft]
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Mel filterbank (Slaney scale + Slaney norm — librosa defaults)
# ---------------------------------------------------------------------------

def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_filterbank(sample_rate: int = DEFAULT_SAMPLE_RATE, n_fft: int = DEFAULT_N_FFT,
                   n_mels: int = DEFAULT_N_MELS, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, shape [n_mels, 1+n_fft//2]."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz_slaney(
        np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# dB conversion and the full mel pipeline
# ---------------------------------------------------------------------------

def power_to_db(S: np.ndarray, ref: Optional[float] = None, amin: float = 1e-10,
                top_db: Optional[float] = 80.0) -> np.ndarray:
    """librosa-compatible power→dB; ``ref=None`` means ``ref=S.max()``."""
    S = np.asarray(S, dtype=np.float64)
    ref_value = np.abs(ref) if ref is not None else np.maximum(amin, S.max())
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def db_to_power(db: np.ndarray, ref: float = 1.0) -> np.ndarray:
    return ref * np.power(10.0, 0.1 * np.asarray(db, dtype=np.float64))


def compute_mel_spectrogram(audio: np.ndarray,
                            sample_rate: int = DEFAULT_SAMPLE_RATE,
                            n_fft: int = DEFAULT_N_FFT,
                            hop_length: int = DEFAULT_HOP,
                            win_length: int = DEFAULT_WIN,
                            n_mels: int = DEFAULT_N_MELS,
                            fmin: float = 0.0,
                            fmax: Optional[float] = None) -> np.ndarray:
    """Audio → normalised log-mel in [-1, 1], shape [n_mels, n_frames]:
    power mel → ``power_to_db`` (ref = max, top_db = 80) → per-utterance
    min-max normalisation (reference src/utils/audio.py:45-98)."""
    spec = np.abs(stft(audio, n_fft, hop_length, win_length)) ** 2.0
    mel = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax) @ spec
    mel_db = power_to_db(mel)
    lo, hi = mel_db.min(), mel_db.max()
    if hi - lo < 1e-8:
        return np.zeros_like(mel_db, dtype=np.float32)
    return (2.0 * (mel_db - lo) / (hi - lo) - 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Griffin-Lim inversion (validation path, pre-vocoder)
# ---------------------------------------------------------------------------

def griffin_lim(magnitude: np.ndarray, n_iter: int = 32,
                hop_length: int = DEFAULT_HOP, win_length: Optional[int] = None,
                momentum: float = 0.99) -> np.ndarray:
    """Griffin-Lim with momentum on an STFT magnitude [freq, frames]; the
    starting phases come from ``default_rng(0)``."""
    n_fft = 2 * (magnitude.shape[0] - 1)
    win_length = win_length or n_fft
    rng = np.random.default_rng(0)
    angles = np.exp(2j * np.pi * rng.random(magnitude.shape))
    rebuilt = np.zeros_like(angles)
    for _ in range(n_iter):
        audio = istft(magnitude * angles, hop_length, win_length)
        tprev = rebuilt
        rebuilt = stft(audio, n_fft, hop_length, win_length)
        rebuilt = rebuilt[:, : magnitude.shape[1]]
        if rebuilt.shape[1] < magnitude.shape[1]:
            rebuilt = np.pad(rebuilt, ((0, 0), (0, magnitude.shape[1] - rebuilt.shape[1])))
        angles = rebuilt - (momentum / (1 + momentum)) * tprev
        denom = np.abs(angles)
        angles = angles / np.maximum(denom, 1e-16)
    return istft(magnitude * angles, hop_length, win_length)


def mel_to_audio(mel: np.ndarray,
                 sample_rate: int = DEFAULT_SAMPLE_RATE,
                 n_fft: int = DEFAULT_N_FFT,
                 hop_length: int = DEFAULT_HOP,
                 win_length: int = DEFAULT_WIN,
                 n_iter: int = 32,
                 fmin: float = 0.0,
                 fmax: Optional[float] = None,
                 reference_denorm: bool = True) -> np.ndarray:
    """Normalized log-mel [n_mels, frames] → audio via pinv(mel basis) +
    Griffin-Lim, peak-normalised.

    ``reference_denorm=True`` applies the reference's ``(mel+1)/2`` before
    ``db_to_power`` — not the true inverse of the min-max normalization,
    kept for behavioral parity with the JAX package.
    """
    mel = np.asarray(mel, dtype=np.float64)
    if reference_denorm:
        mel_power = db_to_power((mel + 1.0) / 2.0)
    else:
        # best-effort inverse assuming the full 80 dB range was used
        mel_power = db_to_power(mel * 40.0 - 40.0)
    basis = mel_filterbank(sample_rate, n_fft, mel.shape[0], fmin, fmax).astype(np.float64)
    inv = np.linalg.pinv(basis)
    spec_power = np.maximum(0.0, inv @ mel_power)
    magnitude = np.sqrt(spec_power)
    audio = griffin_lim(magnitude, n_iter, hop_length, win_length)
    peak = np.max(np.abs(audio))
    if peak > 0:
        audio = audio / peak
    return audio.astype(np.float32)


def validate_audio_params(sample_rate: int, n_fft: int, hop_length: int,
                          win_length: int, n_mels: int, fmin: float = 0.0,
                          fmax: Optional[float] = None) -> None:
    """Raise on inconsistent DSP parameters; warn on suspicious ones.

    The reference ships validate_audio_config (reference
    src/utils/audio.py:260-286) but never calls it and it silently CLAMPS
    values to Apple-M2 limits; here invalid combinations fail loudly at
    construction time instead (AudioProcessor calls this), and there are
    no hardware clamps.
    """
    import warnings

    if n_fft <= 0 or (n_fft & (n_fft - 1)) != 0:
        raise ValueError(f"n_fft must be a positive power of two, got {n_fft}")
    if not (0 < hop_length <= n_fft):
        raise ValueError(f"hop_length must be in (0, n_fft], got {hop_length}")
    if not (0 < win_length <= n_fft):
        raise ValueError(f"win_length must be in (0, n_fft], got {win_length}")
    if not (0 < n_mels <= 1 + n_fft // 2):
        raise ValueError(f"n_mels must be in (0, 1+n_fft/2], got {n_mels}")
    eff_fmax = fmax if fmax is not None else sample_rate / 2.0
    if not (0.0 <= fmin < eff_fmax):
        raise ValueError(f"need 0 <= fmin < fmax, got fmin={fmin} fmax={eff_fmax}")
    if eff_fmax > sample_rate / 2.0:
        raise ValueError(f"fmax {eff_fmax} exceeds Nyquist {sample_rate / 2.0}")
    if hop_length > win_length:
        warnings.warn(f"hop_length {hop_length} > win_length {win_length}: "
                      "frames will not overlap", stacklevel=2)


class AudioProcessor:
    """The DSP pipeline with fixed parameters: ``process_file`` → (audio,
    normalised mel [n_mels, frames]) and ``mel_to_audio`` for Griffin-Lim.

    ``use_native``: ``'auto'`` computes mels with the C++ frontend
    (``frontend/native.py``) when it builds and loads, else with NumPy;
    ``True`` raises ``RuntimeError`` when it cannot; ``False`` never tries.
    The two paths agree within 2e-5 (``tests/test_torch_native.py``)."""

    def __init__(self, sample_rate: int = DEFAULT_SAMPLE_RATE,
                 n_fft: int = DEFAULT_N_FFT, hop_length: int = DEFAULT_HOP,
                 win_length: int = DEFAULT_WIN, n_mels: int = DEFAULT_N_MELS,
                 fmin: float = 0.0, fmax: Optional[float] = None,
                 use_native: Union[str, bool] = "auto"):
        validate_audio_params(sample_rate, n_fft, hop_length, win_length,
                              n_mels, fmin, fmax)
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mels = n_mels
        self.fmin = fmin
        self.fmax = fmax if fmax is not None else sample_rate / 2.0
        self._native = None
        if use_native in ("auto", True):
            from m2tts_tpu_torch.frontend import native

            if native.native_available():
                self._native = native
            elif use_native is True:
                raise RuntimeError("native mel frontend requested but it "
                                   "could not be built or loaded")

    @classmethod
    def from_config(cls, data_cfg) -> "AudioProcessor":
        """Build from a config ``data`` group (the 5-group YAML schema).

        The single mapping from config keys to DSP parameters — trainers
        and evaluation must construct their processors through this so a
        new mel key can never diverge between training and eval features.
        """
        if data_cfg is None:
            return cls()
        get = data_cfg.get
        return cls(sample_rate=int(get("sample_rate", DEFAULT_SAMPLE_RATE)),
                   n_fft=int(get("n_fft", DEFAULT_N_FFT)),
                   hop_length=int(get("hop_length", DEFAULT_HOP)),
                   win_length=int(get("win_length", DEFAULT_WIN)),
                   n_mels=int(get("n_mels", DEFAULT_N_MELS)),
                   fmin=float(get("fmin", 0)),
                   fmax=get("fmax"))

    def compute_mel(self, audio: np.ndarray) -> np.ndarray:
        if self._native is not None:
            try:
                return self._native.compute_mel_native(
                    audio, self.sample_rate, self.n_fft, self.hop_length,
                    self.win_length, self.n_mels, self.fmin, self.fmax)
            except ValueError:
                pass  # shorter than one frame: the NumPy path pads it
        return compute_mel_spectrogram(audio, self.sample_rate, self.n_fft,
                                       self.hop_length, self.win_length,
                                       self.n_mels, self.fmin, self.fmax)

    def process_file(self, path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray]:
        audio, _ = load_wav(path, self.sample_rate)
        return audio, self.compute_mel(audio)

    def mel_to_audio(self, mel: np.ndarray, n_iter: int = 32) -> np.ndarray:
        return mel_to_audio(mel, self.sample_rate, self.n_fft, self.hop_length,
                            self.win_length, n_iter, self.fmin, self.fmax)
