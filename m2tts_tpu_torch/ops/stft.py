"""STFT and log-mel features for the stage-2 training losses, on the
tensors' device.

Counterpart of ``m2tts_tpu/ops/stft.py``: centred reflect padding, a
periodic Hann window (``win_length`` zero-padded to ``n_fft``), the frames
taken by one static gather, ``torch.fft.rfft``. The reflect padding and the
framing are folded into one index table, built on the host with
``np.pad(mode="reflect")`` (numpy's repeated reflection, as ``jnp.pad``
does, so a pad longer than the signal is allowed) and kept on the device
per (length, n_fft, hop), so a call copies nothing from the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from m2tts_tpu_torch.frontend.audio import hann_window, mel_filterbank


def _window(n_fft: int, win_length: Optional[int]) -> np.ndarray:
    win_length = win_length or n_fft
    w = hann_window(win_length).astype(np.float32)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad))


@functools.lru_cache(maxsize=64)
def _tables(length: int, n_fft: int, hop_length: int, center: bool,
            win_length: Optional[int], device: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frame index table [n_frames, n_fft] into the unpadded signal, the
    window [n_fft]) on ``device``."""
    src = np.arange(length)
    if center:
        src = np.pad(src, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(src) - n_fft) // hop_length
    idx = src[np.arange(n_frames)[:, None] * hop_length
              + np.arange(n_fft)[None, :]]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(_window(n_fft, win_length)).to(device))


def frame(x: torch.Tensor, n_fft: int, hop_length: int,
          center: bool = True) -> torch.Tensor:
    """[B, T] → [B, n_frames, n_fft] framing by one gather."""
    idx, _ = _tables(x.shape[-1], n_fft, hop_length, center, None,
                     str(x.device))
    return x[:, idx]


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, center: bool = True
         ) -> torch.Tensor:
    """Complex STFT [B, n_frames, 1 + n_fft//2]."""
    idx, w = _tables(x.shape[-1], n_fft, hop_length, center, win_length,
                     str(x.device))
    return torch.fft.rfft(x[:, idx] * w.to(x.dtype), n=n_fft, dim=-1)


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: Optional[int] = None) -> torch.Tensor:
    return stft(x, n_fft, hop_length, win_length).abs()


@functools.lru_cache(maxsize=16)
def mel_basis(sample_rate: int, n_fft: int, n_mels: int,
              device: str) -> torch.Tensor:
    """The Slaney filterbank [n_mels, 1 + n_fft//2] on ``device``."""
    return torch.from_numpy(mel_filterbank(sample_rate, n_fft,
                                           n_mels)).to(device)


def log_mel_features(x: torch.Tensor, sample_rate: int = 22050,
                     n_fft: int = 1024, hop_length: int = 256,
                     n_mels: int = 80) -> torch.Tensor:
    """Log-mel features [B, frames, n_mels] over a Slaney filterbank, for
    the perceptual loss."""
    basis = mel_basis(sample_rate, n_fft, n_mels, str(x.device)).to(x.dtype)
    mag = stft_magnitude(x, n_fft, hop_length)  # [B, T, F]
    return torch.log(torch.einsum("btf,mf->btm", mag, basis) + 1e-8)
