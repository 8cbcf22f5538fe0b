"""Static-shape length regulation (FastSpeech expand) as tensor ops.

Counterpart of ``m2tts_tpu/ops/length_regulator.py``:

    frames = max(floor(durations), 0)             # [B, S] int
    ends   = cumsum(frames)                       # [B, S]
    idx[b, t] = #{ j : ends[b, j] <= t }          # rank of frame t
    out[b, t] = x[b, min(idx[b, t], S-1)] * (t < total_b)

``ends`` is non-decreasing, so the rank count is a ``searchsorted`` with
``right=True``: the same integers as the JAX broadcast-compare-sum,
without the [B, T, S] intermediate.
"""

from __future__ import annotations

from typing import Tuple

import torch


def duration_to_frame_indices(durations: torch.Tensor, max_frames: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """[B, S] non-negative durations → (idx [B, T] int64 clamped to S-1,
    mask [B, T] bool, total [B] int32 uncapped)."""
    frames = torch.floor(durations).to(torch.int32).clamp_min(0)
    ends = torch.cumsum(frames, dim=1, dtype=torch.int32)  # [B, S]
    t = torch.arange(max_frames, dtype=torch.int32, device=durations.device)
    idx = torch.searchsorted(ends, t.expand(ends.shape[0], -1).contiguous(),
                             right=True)
    total = ends[:, -1]
    mask = t[None, :] < total[:, None]
    idx = idx.clamp_max(durations.shape[1] - 1)
    return idx, mask, total


def regulate_lengths(x: torch.Tensor, durations: torch.Tensor,
                     max_frames: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand phoneme hiddens [B, S, H] to frame rate [B, T, H], zero
    beyond each total; returns (out, mask, total)."""
    idx, mask, total = duration_to_frame_indices(durations, max_frames)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    out = out * mask[..., None].to(x.dtype)
    return out, mask, total
