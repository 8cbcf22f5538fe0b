"""G.711 μ-law for serving: an on-device encode of int16 PCM as torch
integer ops, and the numpy tables for host-side encode and decode.

Counterpart of ``m2tts_tpu/ops/audio_codec.py``: the exact bit-level G.711
algorithm (bias 0x84, clip 32635, segment exponent + 4-bit mantissa,
complemented output), branch-free so it runs on the device and the audio
leaves it already companded, at one byte a sample.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = 0x84  # 132
_CLIP = 32635
_THRESHOLDS = (256, 512, 1024, 2048, 4096, 8192, 16384)


def mulaw_encode_pcm16(pcm: torch.Tensor) -> torch.Tensor:
    """Exact G.711 μ-law encode of int16 PCM; returns uint8, same shape.

    The segment exponent floor(log2(biased >> 7)) is a sum of seven
    threshold comparisons; the mantissa is a per-element right shift.
    """
    s = pcm.to(torch.int32)
    sign = (s < 0).to(torch.int32) << 7
    mag = torch.clamp(s.abs(), max=_CLIP) + _BIAS  # [132, 32767]
    exponent = torch.zeros_like(mag)
    for threshold in _THRESHOLDS:
        exponent += (mag >= threshold).to(torch.int32)
    mantissa = torch.bitwise_right_shift(mag, exponent + 3) & 0x0F
    byte = ~(sign | (exponent << 4) | mantissa) & 0xFF
    return byte.to(torch.uint8)


def mulaw_encode_f32(audio: torch.Tensor) -> torch.Tensor:
    """f32 waveform in [-1, 1] → μ-law bytes: clipped, quantised to int16
    as the serving PCM is, then G.711."""
    pcm = (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)
    return mulaw_encode_pcm16(pcm)


def _build_decode_table() -> np.ndarray:
    u = np.arange(256, dtype=np.int32) ^ 0xFF  # ~byte, as uint8 bits
    sign = (u & 0x80) != 0
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    t = ((mantissa << 3) + _BIAS) << exponent
    lin = np.where(sign, _BIAS - t, t - _BIAS)
    return lin.astype(np.int16)


#: 256-entry μ-law byte → linear int16 table (host-side decode).
MULAW_DECODE_TABLE: np.ndarray = _build_decode_table()


def mulaw_decode_np(data: np.ndarray) -> np.ndarray:
    """μ-law bytes → int16 PCM (one table-gather pass on the host)."""
    return MULAW_DECODE_TABLE[np.asarray(data, dtype=np.uint8)]


def _build_encode_table() -> np.ndarray:
    """All 65536 int16 codes → μ-law byte, by the same bit algorithm in
    numpy (the independent cross-check of the torch encoder)."""
    s = np.arange(-32768, 32768, dtype=np.int32)
    sign = np.where(s < 0, 0x80, 0)
    mag = np.minimum(np.abs(s), _CLIP) + _BIAS
    exponent = np.zeros_like(mag)
    for threshold in _THRESHOLDS:
        exponent += (mag >= threshold).astype(np.int32)
    mantissa = (mag >> (exponent + 3)) & 0x0F
    byte = ~(sign | (exponent << 4) | mantissa) & 0xFF
    return byte.astype(np.uint8)


#: 65536-entry int16 (offset by 32768) → μ-law byte table.
MULAW_ENCODE_TABLE: np.ndarray = _build_encode_table()


def mulaw_encode_np(pcm: np.ndarray) -> np.ndarray:
    """Host-side int16 → μ-law byte (one table-gather pass)."""
    return MULAW_ENCODE_TABLE[np.asarray(pcm, dtype=np.int64) + 32768]
