"""STOI — Short-Time Objective Intelligibility (Taal et al., ICASSP 2011).

A copy of ``m2tts_tpu/evaluation/stoi.py`` for the PyTorch port: an
intrusive (reference-audio) intelligibility metric in NumPy +
scipy.signal, which the stage-2 validation gate uses.

Algorithm (classic STOI, not the extended variant):
  1. resample clean + degraded to 10 kHz,
  2. remove silent frames (energy < clean max − 40 dB, 256/128 Hann),
  3. STFT (256-sample frames zero-padded to 512, hop 128),
  4. 15 one-third-octave bands, first center 150 Hz,
  5. short-time segments of N=30 frames; per band/segment normalize the
     degraded energies to the clean norm and clip at +15 dB SDR,
  6. average the per-band/segment correlation coefficients.

Output is ~(0, 1]; higher is more intelligible. Identical signals → 1.0;
monotonically degrades with added noise.
"""

from __future__ import annotations

from math import gcd

import numpy as np

FS = 10000          # internal sample rate (Hz)
FRAME = 256         # analysis frame length at FS
HOP = 128
NFFT = 512
N_BANDS = 15
FIRST_CF = 150.0    # Hz, first one-third-octave center frequency
SEG_FRAMES = 30     # ~384 ms analysis segments
BETA = -15.0        # dB, SDR clip
DYN_RANGE = 40.0    # dB, silent-frame removal threshold


def _resample(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == FS:
        return np.asarray(x, np.float64)
    from scipy.signal import resample_poly

    g = gcd(FS, sr)
    return resample_poly(np.asarray(x, np.float64), FS // g, sr // g)


def _frames(x: np.ndarray) -> np.ndarray:
    """[n_frames, FRAME] Hann-windowed frames, hop HOP."""
    n = (len(x) - FRAME) // HOP + 1
    if n < 1:
        return np.zeros((0, FRAME))
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx] * np.hanning(FRAME)[None, :]


def _third_octave_matrix(sr: int = FS, nfft: int = NFFT) -> np.ndarray:
    """[N_BANDS, nfft//2+1] boolean band-membership matrix."""
    f = np.linspace(0, sr / 2, nfft // 2 + 1)
    cfs = FIRST_CF * 2.0 ** (np.arange(N_BANDS) / 3.0)
    lo = cfs * 2.0 ** (-1.0 / 6.0)
    hi = cfs * 2.0 ** (1.0 / 6.0)
    H = np.zeros((N_BANDS, len(f)))
    for k in range(N_BANDS):
        # each bin belongs to the band whose edges bracket it (bins are
        # assigned by nearest-edge rounding, as in the reference matlab)
        i_lo = int(np.argmin((f - lo[k]) ** 2))
        i_hi = int(np.argmin((f - hi[k]) ** 2))
        H[k, i_lo:i_hi] = 1.0
    return H


def compute_stoi(clean: np.ndarray, degraded: np.ndarray,
                 sample_rate: int = 22050) -> float:
    """STOI of ``degraded`` against ``clean`` (same sample rate, any
    length ≥ a few frames). Returns NaN when the clean signal has no
    active speech frames or is too short to form one analysis frame."""
    x = _resample(np.asarray(clean, np.float64).squeeze(), sample_rate)
    y = _resample(np.asarray(degraded, np.float64).squeeze(), sample_rate)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]

    # silent-frame removal, thresholded on the CLEAN signal
    xf = _frames(x)
    yf = _frames(y)
    if xf.shape[0] == 0:
        return float("nan")
    energy_db = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy_db > energy_db.max() - DYN_RANGE
    xf, yf = xf[keep], yf[keep]
    if xf.shape[0] < 2:
        return float("nan")

    X = np.abs(np.fft.rfft(xf, NFFT, axis=1)) ** 2  # [M, F]
    Y = np.abs(np.fft.rfft(yf, NFFT, axis=1)) ** 2
    H = _third_octave_matrix()
    Xb = np.sqrt(X @ H.T)  # [M, N_BANDS] band magnitudes
    Yb = np.sqrt(Y @ H.T)

    M = Xb.shape[0]
    seg = min(SEG_FRAMES, M)  # short signals: one full-length segment
    clip = 10.0 ** (-BETA / 20.0)
    d_sum, d_cnt = 0.0, 0
    for m in range(seg, M + 1):
        xs = Xb[m - seg:m]  # [seg, bands]
        ys = Yb[m - seg:m]
        alpha = (np.linalg.norm(xs, axis=0)
                 / (np.linalg.norm(ys, axis=0) + 1e-12))[None, :]
        ys_n = np.minimum(alpha * ys, (1.0 + clip) * xs)
        xs_c = xs - xs.mean(axis=0, keepdims=True)
        ys_c = ys_n - ys_n.mean(axis=0, keepdims=True)
        denom = (np.linalg.norm(xs_c, axis=0)
                 * np.linalg.norm(ys_c, axis=0) + 1e-12)
        d = (xs_c * ys_c).sum(axis=0) / denom
        d_sum += float(d.sum())
        d_cnt += d.size
    return d_sum / d_cnt if d_cnt else float("nan")
