"""The heuristic MOS estimator of the in-training sample validator.

A copy of ``estimate_mos_score`` and its helpers from
``m2tts_tpu/evaluation/metrics.py:24-137`` (same normalisations, weights and
clips): an approximation from signal statistics, not a human MOS. The rest
of the evaluation layer is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from m2tts_tpu_torch.frontend.audio import stft as np_stft


def _magnitude(audio: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    return np.abs(np_stft(np.asarray(audio, np.float64), n_fft, hop))


def compute_spectral_convergence(pred_audio: np.ndarray,
                                 target_audio: np.ndarray) -> float:
    """Frobenius-norm STFT convergence (reference metrics.py:27-41)."""
    p = _magnitude(pred_audio)
    t = _magnitude(target_audio)
    n = min(p.shape[1], t.shape[1])
    p, t = p[:, :n], t[:, :n]
    return float(np.linalg.norm(t - p, ord="fro")
                 / (np.linalg.norm(t, ord="fro") + 1e-8))


def compute_log_spectral_distance(pred_audio: np.ndarray,
                                  target_audio: np.ndarray) -> float:
    """LSD: RMS of log-magnitude differences (reference metrics.py:44-58)."""
    p = np.log(_magnitude(pred_audio) + 1e-8)
    t = np.log(_magnitude(target_audio) + 1e-8)
    n = min(p.shape[1], t.shape[1])
    diff = p[:, :n] - t[:, :n]
    return float(np.sqrt(np.mean(diff ** 2)))


def _spectral_centroid(mag: np.ndarray, sample_rate: int) -> np.ndarray:
    """Per-frame magnitude-weighted mean frequency. mag: [F, T]."""
    freqs = np.linspace(0, sample_rate / 2, mag.shape[0])[:, None]
    norm = mag / (mag.sum(axis=0, keepdims=True) + 1e-10)
    return (freqs * norm).sum(axis=0)


def _spectral_bandwidth(mag: np.ndarray, sample_rate: int, p: int = 2
                        ) -> np.ndarray:
    freqs = np.linspace(0, sample_rate / 2, mag.shape[0])[:, None]
    centroid = _spectral_centroid(mag, sample_rate)[None, :]
    norm = mag / (mag.sum(axis=0, keepdims=True) + 1e-10)
    return (norm * np.abs(freqs - centroid) ** p).sum(axis=0) ** (1.0 / p)


def estimate_mos_score(pred_audio: np.ndarray,
                       target_audio: Optional[np.ndarray] = None,
                       sample_rate: int = 22050) -> Dict[str, float]:
    """Heuristic MOS ∈ [1, 5] from signal statistics — an approximation,
    NOT a human MOS (reference metrics.py:79-148; same weights/clips)."""
    pred_audio = np.asarray(pred_audio, np.float64).squeeze()
    scores: Dict[str, float] = {}

    snr = spec_conv = lsd = None
    if target_audio is not None:
        target_audio = np.asarray(target_audio, np.float64).squeeze()
        n = min(len(pred_audio), len(target_audio))
        p, t = pred_audio[:n], target_audio[:n]
        noise = p - t
        snr = 10 * np.log10(np.mean(t ** 2) / (np.mean(noise ** 2) + 1e-8))
        scores["snr_db"] = float(snr)
        spec_conv = compute_spectral_convergence(p, t)
        scores["spectral_convergence"] = float(spec_conv)
        lsd = compute_log_spectral_distance(p, t)
        scores["log_spectral_distance"] = float(lsd)

    scores["rms_energy"] = float(np.sqrt(np.mean(pred_audio ** 2)))
    scores["zero_crossing_rate"] = float(
        np.mean(np.abs(np.diff(np.sign(pred_audio)))))

    mag = _magnitude(pred_audio)
    scores["spectral_centroid"] = float(_spectral_centroid(mag, sample_rate).mean())
    scores["spectral_bandwidth"] = float(_spectral_bandwidth(mag, sample_rate).mean())

    if target_audio is not None:
        snr_score = np.clip((snr + 20) / 40, 0, 1)
        spec_score = np.clip(1 - spec_conv, 0, 1)
        lsd_score = np.clip(1 - lsd / 5, 0, 1)
        mos = 1 + 4 * (0.4 * snr_score + 0.3 * spec_score + 0.3 * lsd_score)
    else:
        energy_score = np.clip(scores["rms_energy"] * 10, 0, 1)
        brightness_score = np.clip(scores["spectral_centroid"] / 3000, 0, 1)
        mos = 1 + 4 * (0.5 * energy_score + 0.5 * brightness_score)
    scores["estimated_mos"] = float(np.clip(mos, 1.0, 5.0))
    return scores
