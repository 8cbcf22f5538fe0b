"""Training losses (stage 1 and stage 2) as device tensors.

Counterpart of ``m2tts_tpu/training/losses.py``; nothing here reads a value
on the host.

- ``stage1_losses``: masked mel L1 (each sample's L1 averaged over its
  valid frames, then the batch mean) + duration MSE;
- ``multi_resolution_stft_loss``: magnitude L1 + ``phase_weight`` × phase
  (angle) L1 at n_fft 512/1024/2048, hop n_fft/4;
- ``perceptual_loss``: log-mel L1 over a Slaney filterbank;
- ``envelope_correlation_loss``: 1 − mean Pearson correlation of per-band
  energy envelopes;
- LSGAN discriminator/generator losses and feature matching, normalised
  by scales × features per scale;
- ``combined_generator_loss`` with the generator weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from m2tts_tpu_torch.ops.stft import log_mel_features, mel_basis, stft

STFT_RESOLUTIONS = (512, 1024, 2048)


def masked_mel_l1(mel_pred: torch.Tensor, mel_target: torch.Tensor,
                  mel_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample L1 over its ``[:mel_length]`` frames, averaged over the
    batch; a row of length 0 divides by 1. Shapes [B, T, C]."""
    if mel_lengths is None:
        return (mel_pred - mel_target).abs().mean()
    T = mel_pred.shape[1]
    mask = (torch.arange(T, device=mel_pred.device)[None, :]
            < mel_lengths[:, None]).to(mel_pred.dtype)
    per_frame = (mel_pred - mel_target).abs().mean(dim=-1)  # [B, T]
    per_sample = ((per_frame * mask).sum(dim=1)
                  / torch.clamp(mask.sum(dim=1), min=1.0))
    return per_sample.mean()


def duration_mse(duration_pred: torch.Tensor,
                 duration_target: torch.Tensor) -> torch.Tensor:
    """Unmasked MSE over the padded grid (padding is zero in both)."""
    return ((duration_pred - duration_target) ** 2).mean()


def stage1_losses(mel_pred: torch.Tensor, mel_target: torch.Tensor,
                  duration_pred: torch.Tensor, duration_target: torch.Tensor,
                  mel_lengths: Optional[torch.Tensor],
                  mel_weight: float = 1.0, duration_weight: float = 0.1
                  ) -> Dict[str, torch.Tensor]:
    mel_loss = masked_mel_l1(mel_pred, mel_target, mel_lengths)
    dur_loss = duration_mse(duration_pred, duration_target)
    return {
        "mel_loss": mel_loss,
        "duration_loss": dur_loss,
        "total_loss": mel_weight * mel_loss + duration_weight * dur_loss,
    }


def multi_resolution_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                               resolutions: Sequence[int] = STFT_RESOLUTIONS,
                               phase_weight: float = 0.1) -> torch.Tensor:
    """pred/target: [B, T] waveforms of equal length. At ``phase_weight``
    0 the angle term is not computed (its value would be multiplied by
    0). An exactly-zero bin (a silent stretch of the target) has angle 0:
    torch's FFT may return -0, whose angle is pi, so ``+ 0.0`` clears the
    sign first. The frames centred on the first and last sample are
    symmetric (reflect padding, symmetric window), so their spectra are
    real up to rounding and their angles ±pi by the rounding's sign, here
    as in the JAX package."""
    total = 0.0
    for n_fft in resolutions:
        hop = n_fft // 4
        sp = stft(pred, n_fft, hop)
        st = stft(target, n_fft, hop)
        total = total + (sp.abs() - st.abs()).abs().mean()
        if phase_weight:
            total = total + phase_weight * (
                torch.angle(sp + 0.0) - torch.angle(st + 0.0)).abs().mean()
    return total / len(resolutions)


def perceptual_loss(pred: torch.Tensor, target: torch.Tensor,
                    sample_rate: int = 22050, n_mels: int = 80
                    ) -> torch.Tensor:
    fp = log_mel_features(pred, sample_rate, n_mels=n_mels)
    ft = log_mel_features(target, sample_rate, n_mels=n_mels)
    return (fp - ft).abs().mean()


def envelope_correlation_loss(pred: torch.Tensor, target: torch.Tensor,
                              sample_rate: int = 22050, n_fft: int = 512,
                              hop_length: int = 128,
                              n_bands: int = 16) -> torch.Tensor:
    """1 − mean Pearson correlation of per-band short-time energy
    envelopes (√ of mel-band energy over an n_fft/hop STFT), the quantity
    STOI measures, over [B, T] waveforms."""
    basis = mel_basis(sample_rate, n_fft, n_bands, str(pred.device)).to(
        pred.dtype)

    def env(x):
        spec = stft(x, n_fft, hop_length)
        mag2 = spec.real ** 2 + spec.imag ** 2
        return torch.sqrt(torch.einsum("btf,mf->btm", mag2, basis) + 1e-8)

    ep, et = env(pred), env(target)  # [B, T', M]
    ep = ep - ep.mean(dim=1, keepdim=True)
    et = et - et.mean(dim=1, keepdim=True)
    num = (ep * et).sum(dim=1)
    # eps inside the sqrt: the gradient of an unregularised L2 norm is NaN
    # at zero, and an all-silent band (a zero-padded segment tail) hits it
    den = torch.sqrt(((ep ** 2).sum(dim=1) + 1e-8)
                     * ((et ** 2).sum(dim=1) + 1e-8))
    return 1.0 - (num / den).mean()


def lsgan_discriminator_loss(real_logits: List[torch.Tensor],
                             fake_logits: List[torch.Tensor]
                             ) -> torch.Tensor:
    real = sum(((l - 1.0) ** 2).mean() for l in real_logits)
    fake = sum((l ** 2).mean() for l in fake_logits)
    return (real + fake) / len(real_logits)


def lsgan_generator_loss(fake_logits: List[torch.Tensor]) -> torch.Tensor:
    return sum(((l - 1.0) ** 2).mean() for l in fake_logits) \
        / len(fake_logits)


def feature_matching_loss(real_features: List[List[torch.Tensor]],
                          fake_features: List[List[torch.Tensor]]
                          ) -> torch.Tensor:
    total = 0.0
    for rf, ff in zip(real_features, fake_features):
        for r, f in zip(rf, ff):
            total = total + (f - r).abs().mean()
    return total / (len(real_features) * len(real_features[0]))


def combined_generator_loss(losses: Dict[str, torch.Tensor],
                            mel_weight: float = 1.0,
                            duration_weight: float = 0.1,
                            adversarial_weight=0.25,
                            feature_matching_weight=2.0,
                            spectral_weight: float = 1.0,
                            perceptual_weight: float = 0.5,
                            envelope_weight: float = 0.0) -> torch.Tensor:
    """The weighted generator total over the terms present in ``losses``;
    the adversarial and feature-matching weights may be device tensors
    (the warmup ramp and the adaptive guard)."""
    total = (mel_weight * losses["mel_loss"]
             + duration_weight * losses["duration_loss"])
    if "spectral_loss" in losses:
        total = total + spectral_weight * losses["spectral_loss"]
    if "perceptual_loss" in losses:
        total = total + perceptual_weight * losses["perceptual_loss"]
    if "envelope_loss" in losses:
        total = total + envelope_weight * losses["envelope_loss"]
    if "generator_loss" in losses:
        total = total + adversarial_weight * losses["generator_loss"]
    if "feature_matching_loss" in losses:
        total = total + feature_matching_weight * losses[
            "feature_matching_loss"]
    return total


class EarlyStopping:
    """Patience counter on validation loss."""

    def __init__(self, patience: int = 10000, min_delta: float = 0.001):
        self.patience = patience
        self.min_delta = min_delta
        self.best_loss = float("inf")
        self.wait = 0

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.wait = 0
        else:
            self.wait += 1
        return self.wait >= self.patience
