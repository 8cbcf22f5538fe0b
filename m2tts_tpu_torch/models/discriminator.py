"""Multi-scale waveform discriminator (MelGAN-style) for stage-2 GAN
training, as plain torch convs.

Counterpart of ``m2tts_tpu/models/discriminator.py:22-62, :162-180``: three
scales (×1, ×2, ×4 average pooling, the remainder truncated), each a stack
of six convs (grouped in the middle, strided by 4) with LeakyReLU(0.2) and a
k=3 output conv; per scale the logits and the six feature maps taken before
each activation. Parameter names follow the flax tree
(``scale{i}.conv{j}.conv.weight``), so ``utils.params.from_flax`` converts
it. The phase-packed lowering of the JAX package (``:65-159``) computes the
same function for the TPU's matrix unit and has no counterpart here. Inside
a scale the activations stay in torch's [B, C, T] layout; the outputs are
[B, T, C] views, as the flax module returns them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from m2tts_tpu_torch.models.components import Conv1d

# (features, kernel, stride, groups) per conv layer
_LAYERS = (
    (64, 15, 1, 1),
    (128, 41, 4, 4),
    (256, 41, 4, 16),
    (512, 41, 4, 64),
    (1024, 41, 4, 256),
    (1024, 5, 1, 1),
)


class ScaleDiscriminator(nn.Module):
    """Single-scale conv stack [B, T, 1] → (logits [B, T', 1], six feature
    maps [B, T_j, C_j]); ``spectral_norm`` normalises every conv's weight
    at each application."""

    def __init__(self, spectral_norm: bool = False):
        super().__init__()
        cin = 1
        for i, (ch, k, s, g) in enumerate(_LAYERS):
            self.add_module(f"conv{i}", Conv1d(
                cin, ch, k, groups=g, stride=s, spectral_norm=spectral_norm))
            cin = ch
        self.conv_out = Conv1d(cin, 1, 3, spectral_norm=spectral_norm)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        features = []
        h = x.transpose(1, 2)
        for i in range(len(_LAYERS)):
            h = getattr(self, f"conv{i}").channels_first(h)
            features.append(h.transpose(1, 2))  # pre-activation
            h = F.leaky_relu(h, negative_slope=0.2)
        return self.conv_out.channels_first(h).transpose(1, 2), features


def _avg_pool1d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping average pooling on [B, T, C]; the remainder of T
    past a multiple of ``factor`` is dropped."""
    B, T, C = x.shape
    T2 = (T // factor) * factor
    return x[:, :T2].reshape(B, T2 // factor, factor, C).mean(dim=2)


class MultiScaleDiscriminator(nn.Module):
    """Three ``ScaleDiscriminator``s over progressively pooled audio."""

    def __init__(self, scales: Sequence[int] = (1, 2, 4),
                 spectral_norm: bool = False):
        super().__init__()
        self.scales = tuple(scales)
        self.spectral_norm = spectral_norm
        for i in range(len(self.scales)):
            self.add_module(f"scale{i}", ScaleDiscriminator(spectral_norm))

    def forward(self, audio: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
        """audio [B, T] or [B, T, 1] → (logits per scale, features per
        scale)."""
        if audio.dim() == 2:
            audio = audio[..., None]
        logits, feature_maps = [], []
        for i, scale in enumerate(self.scales):
            x = _avg_pool1d(audio, scale) if scale > 1 else audio
            out, feats = getattr(self, f"scale{i}")(x)
            logits.append(out)
            feature_maps.append(feats)
        return logits, feature_maps
