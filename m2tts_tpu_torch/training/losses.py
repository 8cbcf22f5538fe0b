"""Stage-1 losses: masked mel L1 + duration MSE, as device tensors.

Counterpart of ``m2tts_tpu/training/losses.py:38-71, :191-206``. The mel
term is a mask-weighted reduction (each sample's L1 averaged over its
valid frames, then the batch mean); nothing here reads a value on the
host. The stage-2 losses are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


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
