"""Quality metrics of the in-training validation (NumPy on the host).

A copy of ``m2tts_tpu/evaluation/metrics.py`` for the PyTorch port: mel
distances, spectral convergence, log-spectral distance, MFCC mel-cepstral
distortion, the heuristic MOS estimator (an approximation from signal
statistics, not a human MOS), duration accuracy, ``TTSEvaluator`` and
``aggregate_metrics``, with the same normalisations, weights and clips;
mels are channel-last [T, C]. ``benchmark_model_performance`` and
``benchmark_audio_quality`` run the port's ``M2TTS`` teacher-forced in eval
mode (the vocoder as the f32 ``Vocoder`` module) on the weights they are
given, one eager callable per bucket.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from m2tts_tpu_torch.frontend.audio import stft as np_stft


def _magnitude(audio: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    return np.abs(np_stft(np.asarray(audio, np.float64), n_fft, hop))


def compute_mel_distance(pred_mel: np.ndarray, target_mel: np.ndarray
                         ) -> Dict[str, float]:
    """L1/L2/combined mel distance."""
    pred_mel = np.asarray(pred_mel, np.float64)
    target_mel = np.asarray(target_mel, np.float64)
    l1 = float(np.abs(pred_mel - target_mel).mean())
    l2 = float(((pred_mel - target_mel) ** 2).mean())
    return {
        "mel_l1_distance": l1,
        "mel_l2_distance": l2,
        "mel_combined_distance": l1 + float(np.sqrt(l2)),
    }


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


def _mfcc_from_mel(mel_db: np.ndarray, n_mfcc: int = 13) -> np.ndarray:
    """DCT-II (ortho) over the mel axis (librosa.feature.mfcc(S=...)).
    mel_db: [C, T] → [n_mfcc, T]."""
    from scipy.fftpack import dct

    return dct(mel_db, axis=0, type=2, norm="ortho")[:n_mfcc]


def compute_mcd(pred_mel: np.ndarray, target_mel: np.ndarray,
                n_mfcc: int = 13) -> float:
    """MFCC-based mel-cepstral distortion of [C, T] mels."""
    p = _mfcc_from_mel(np.asarray(pred_mel, np.float64), n_mfcc)
    t = _mfcc_from_mel(np.asarray(target_mel, np.float64), n_mfcc)
    n = min(p.shape[1], t.shape[1])
    diff = p[:, :n] - t[:, :n]
    return float(np.mean(np.sqrt(np.sum(diff ** 2, axis=0))))


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


def compute_duration_accuracy(pred_durations: np.ndarray,
                              target_durations: np.ndarray) -> Dict[str, float]:
    """L1/L2/Pearson on durations."""
    p = np.asarray(pred_durations, np.float64).flatten()
    t = np.asarray(target_durations, np.float64).flatten()
    l1 = float(np.abs(p - t).mean())
    l2 = float(((p - t) ** 2).mean())
    if len(p) > 1 and p.std() > 0 and t.std() > 0:
        corr = float(np.corrcoef(p, t)[0, 1])
        if np.isnan(corr):
            corr = 0.0
    else:
        corr = 0.0
    return {"duration_l1_loss": l1, "duration_l2_loss": l2,
            "duration_correlation": corr}


class TTSEvaluator:
    """Per-sample and per-batch aggregation, and a readable report. Mels
    are channel-last [T, C]."""

    def __init__(self, sample_rate: int = 22050):
        self.sample_rate = sample_rate

    def evaluate_sample(self, pred_mel, target_mel, pred_audio=None,
                        target_audio=None, pred_durations=None,
                        target_durations=None) -> Dict[str, float]:
        metrics = dict(compute_mel_distance(pred_mel, target_mel))
        if pred_audio is not None:
            metrics.update(estimate_mos_score(
                np.asarray(pred_audio),
                np.asarray(target_audio) if target_audio is not None else None,
                self.sample_rate))
        if pred_durations is not None and target_durations is not None:
            metrics.update(compute_duration_accuracy(pred_durations,
                                                     target_durations))
        return metrics

    def evaluate_batch(self, pred_mels, target_mels, pred_audios=None,
                       target_audios=None, pred_durations=None,
                       target_durations=None, mel_lengths=None,
                       n_valid: Optional[int] = None) -> Dict[str, float]:
        """Only the first ``n_valid`` rows are aggregated: the rows after
        them repeat earlier samples to fill a bucketed batch."""
        pred_mels = np.asarray(pred_mels)
        target_mels = np.asarray(target_mels)
        all_metrics: List[Dict[str, float]] = []
        n_rows = pred_mels.shape[0] if n_valid is None else min(
            int(n_valid), pred_mels.shape[0])
        for i in range(n_rows):
            pm, tm = pred_mels[i], target_mels[i]
            if mel_lengths is not None:
                L = int(mel_lengths[i])
                pm, tm = pm[:L], tm[:L]
            all_metrics.append(self.evaluate_sample(
                pm, tm,
                None if pred_audios is None else pred_audios[i],
                None if target_audios is None else target_audios[i],
                None if pred_durations is None else pred_durations[i],
                None if target_durations is None else target_durations[i]))
        return aggregate_metrics(all_metrics)

    def generate_evaluation_report(self, metrics: Dict[str, float]) -> str:
        lines = ["TTS Model Evaluation Report", "=" * 40, ""]
        if "estimated_mos" in metrics:
            mos = metrics["estimated_mos"]
            rating = ("Excellent" if mos >= 4.0 else "Good" if mos >= 3.5
                      else "Fair" if mos >= 3.0 else "Poor")
            lines += [f"Overall Quality (Est. MOS): {mos:.2f}/5.0",
                      f"Quality Rating: {rating}", ""]
        lines += ["Detailed Metrics:", "-" * 20]
        for k, v in sorted(metrics.items()):
            lines.append(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
        return "\n".join(lines) + "\n"


def aggregate_metrics(metric_dicts: Iterable[Dict[str, float]]
                      ) -> Dict[str, float]:
    """Mean of every key over the dicts that carry it, keys in first-seen
    order (per-sample dicts may differ: a sample without a usable STOI
    carries none)."""
    metric_dicts = [m for m in metric_dicts if m]
    if not metric_dicts:
        return {}
    keys: List[str] = []
    for m in metric_dicts:
        for key in m:
            if key not in keys:
                keys.append(key)
    return {key: float(np.mean([m[key] for m in metric_dicts if key in m]))
            for key in keys}


def _teacher_forced(model, T: int, run_vocoder: bool):
    """An eager callable (params, host batch) → the model's outputs,
    teacher-forced at ``T`` frames, in eval mode, without gradients, on
    the params' device."""
    def fwd(params: Dict[str, torch.Tensor], batch: Dict) -> Dict:
        dev = next(iter(params.values())).device
        args = tuple(torch.from_numpy(np.asarray(batch[k])).to(dev)
                     for k in ("phoneme_ids", "text_lengths", "durations"))
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return torch.func.functional_call(
                    model, params, args,
                    {"max_frames": T, "run_vocoder": run_vocoder})
        finally:
            model.train(was_training)

    return fwd


def benchmark_model_performance(model, params: Dict[str, torch.Tensor],
                                batches: Iterable[Dict],
                                num_samples: int = 100,
                                sample_rate: int = 22050,
                                _fn_cache: Optional[Dict] = None
                                ) -> Dict[str, float]:
    """Evaluator metrics of ``model`` on ``params`` (a state dict) over
    ``make_batches`` batches: predicted mel and durations against the
    targets. ``_fn_cache`` keeps the per-bucket callables across calls."""
    evaluator = TTSEvaluator(sample_rate)
    all_metrics = []
    processed = 0
    fns = _fn_cache if _fn_cache is not None else {}
    for batch in batches:
        if processed >= num_samples:
            break
        T = batch["mel"].shape[1]
        if T not in fns:
            fns[T] = _teacher_forced(model, T, run_vocoder=False)
        out = fns[T](params, batch)
        n_valid = int(batch.get("n_valid", batch["phoneme_ids"].shape[0]))
        all_metrics.append(evaluator.evaluate_batch(
            out["mel_output"].float().cpu().numpy(), batch["mel"],
            pred_durations=out["duration_pred"].float().cpu().numpy(),
            target_durations=batch["durations"],
            mel_lengths=batch["mel_lengths"], n_valid=n_valid))
        processed += n_valid
    return aggregate_metrics(all_metrics)


def benchmark_audio_quality(model, params: Dict[str, torch.Tensor],
                            batches: Iterable[Dict],
                            num_samples: int = 32,
                            sample_rate: int = 22050,
                            hop_length: int = 256,
                            _fn_cache: Optional[Dict] = None
                            ) -> Dict[str, float]:
    """STOI, spectral convergence and log-spectral distance of full
    teacher-forced utterances (acoustic model + vocoder) against the
    ground-truth recordings; ``batches`` must carry them
    (``make_batches(..., audio_samples=max_frames * hop_length)``). When the
    vocoder's upsampling differs from the hop, the prediction is resampled
    to the recording's rate first."""
    from m2tts_tpu_torch.evaluation.stoi import compute_stoi

    upsample = 1
    for r in model.upsample_rates:
        upsample *= r
    fns = _fn_cache if _fn_cache is not None else {}
    per_sample: List[Dict[str, float]] = []
    for batch in batches:
        if len(per_sample) >= num_samples:
            break
        if "audio" not in batch:
            raise ValueError("benchmark_audio_quality needs batches with "
                             "ground-truth audio (pass audio_samples= to "
                             "make_batches)")
        T = batch["mel"].shape[1]
        key = ("audio", T)
        if key not in fns:
            fns[key] = _teacher_forced(model, T, run_vocoder=True)
        audio_pred = fns[key](params, batch)["audio_output"][..., 0] \
            .float().cpu().numpy()
        n_valid = int(batch.get("n_valid", batch["phoneme_ids"].shape[0]))
        for i in range(n_valid):
            if len(per_sample) >= num_samples:
                break
            n = int(batch["mel_lengths"][i])
            if n <= 0:
                continue
            pred = audio_pred[i, : n * upsample]
            gt = np.asarray(batch["audio"][i, : n * hop_length], np.float64)
            if upsample != hop_length:
                from math import gcd

                from scipy.signal import resample_poly

                g = gcd(hop_length, upsample)
                pred = resample_poly(np.asarray(pred, np.float64),
                                     hop_length // g, upsample // g)
            m = min(len(pred), len(gt))
            pred, gt = pred[:m], gt[:m]
            stoi = compute_stoi(gt, pred, sample_rate)
            entry = {
                "spectral_convergence": compute_spectral_convergence(pred, gt),
                "log_spectral_distance": compute_log_spectral_distance(pred, gt),
            }
            if np.isfinite(stoi):
                entry["stoi"] = float(stoi)
            per_sample.append(entry)
    return aggregate_metrics(per_sample)
