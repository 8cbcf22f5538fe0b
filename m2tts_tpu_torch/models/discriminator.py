"""Multi-scale waveform discriminator (MelGAN-style) for stage-2 GAN
training, as plain torch convs.

Counterpart of ``m2tts_tpu/models/discriminator.py:22-62, :162-180``: three
scales (×1, ×2, ×4 average pooling, the remainder truncated), each a stack
of six convs (grouped in the middle, strided by 4) with LeakyReLU(0.2) and a
k=3 output conv; per scale the logits and the six feature maps taken before
each activation. Parameter names follow the flax tree
(``scale{i}.conv{j}.conv.weight``), so ``utils.params.from_flax`` converts
it. Inside a scale the activations stay in torch's [B, C, T] layout; the
outputs are [B, T, C] views, as the flax module returns them.

``packed_multiscale_apply`` (JAX ``:65-159``) computes the same function on
the module's flat parameter dict with the strided convs re-lowered: the
stride's time phases are packed into the channels and each strided grouped
conv runs as a stride-1 conv (``ops/grouped_conv.py``). The stage-2 trainer
runs it under ``training.disc_lowering: packed``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from m2tts_tpu_torch.models.components import Conv1d
from m2tts_tpu_torch.ops.grouped_conv import VARIANTS, conv1d_s1

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


# -- phase-packed lowering ----------------------------------------------------
# Packing the s time phases into the channel axis (index c·s + p, so each
# group's channels stay one block) turns a Conv1d(k, stride s, groups g,
# padding (k-1)//2) into a stride-1 conv of kp taps (11 at k=41, s=4) with
# s× the channels a group: the same products plus those of the padded
# kernel's zero taps (44 tap slots for 41) on another problem shape. The
# weights are reshuffled in the graph at every apply, never stored packed,
# so checkpoints, ``from_flax`` and the native module stay interchangeable.


def _packed_strided_conv(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, stride: int, groups: int,
                         wgrad: str = "xla") -> torch.Tensor:
    """Conv1d(k, ``stride``, ``groups``, padding (k-1)//2) of ``x``
    [B, C, T] with ``T % stride == 0``, lowered as a stride-1 conv of the
    phase-packed input [B, C·s, T/s] and kernel [Cout, Cin/g·s, kp]."""
    cout, cin_g, k = weight.shape
    s = stride
    pad = (k - 1) // 2
    B, C, T = x.shape
    xp = (x.reshape(B, C, T // s, s).permute(0, 1, 3, 2)
          .reshape(B, C * s, T // s))
    r_lo = (0 - pad) // s                 # floor
    r_hi = (k - 1 - pad) // s
    kp = r_hi - r_lo + 1
    front = -(pad + r_lo * s)             # in [0, s)
    w_ext = F.pad(weight, (front, kp * s - k - front))
    w_packed = (w_ext.reshape(cout, cin_g, kp, s).permute(0, 1, 3, 2)
                .reshape(cout, cin_g * s, kp))
    out = conv1d_s1(xp, w_packed, (-r_lo, r_hi), groups, wgrad)
    return out + bias[:, None]


def _plain_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int, groups: int) -> torch.Tensor:
    return F.conv1d(x, weight, bias, stride=stride,
                    padding=(weight.shape[-1] - 1) // 2, groups=groups)


def packed_scale_apply(scale_params: Dict[str, torch.Tensor],
                       x: torch.Tensor, wgrad: str = "xla"
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``ScaleDiscriminator`` on [B, T, 1] from its parameters
    (``conv{j}.conv.weight`` / ``.bias``) through the phase-packed
    lowering: a strided layer whose input length divides by its stride
    runs packed, any other layer the plain conv. Spectral norm is not
    applied: callers with spectral-normed weights use the module."""
    features = []
    h = x.transpose(1, 2)
    for i, (_, _, s, g) in enumerate(_LAYERS):
        w = scale_params[f"conv{i}.conv.weight"]
        b = scale_params[f"conv{i}.conv.bias"]
        if s > 1 and h.shape[2] % s == 0:
            h = _packed_strided_conv(h, w, b, s, g, wgrad=wgrad)
        else:
            h = _plain_conv(h, w, b, s, g)
        features.append(h.transpose(1, 2))  # pre-activation
        h = F.leaky_relu(h, negative_slope=0.2)
    logits = _plain_conv(h, scale_params["conv_out.conv.weight"],
                         scale_params["conv_out.conv.bias"], 1, 1)
    return logits.transpose(1, 2), features


def packed_multiscale_apply(params: Dict[str, torch.Tensor],
                            audio: torch.Tensor,
                            scales: Sequence[int] = (1, 2, 4),
                            wgrad: str = "xla"
                            ) -> Tuple[List[torch.Tensor],
                                       List[List[torch.Tensor]]]:
    """``MultiScaleDiscriminator(scales)(audio)`` computed from ``params``,
    the module's flat parameter dict (``scale{i}.conv{j}.conv.weight``),
    through the phase-packed lowering; ``wgrad`` is the packed convs'
    weight-gradient lowering (``ops/grouped_conv.VARIANTS``)."""
    if wgrad not in VARIANTS:
        raise ValueError(f"unknown wgrad variant {wgrad!r}")
    if audio.dim() == 2:
        audio = audio[..., None]
    logits, feature_maps = [], []
    for i, scale in enumerate(scales):
        x = _avg_pool1d(audio, scale) if scale > 1 else audio
        prefix = f"scale{i}."
        out, feats = packed_scale_apply(
            {k[len(prefix):]: v for k, v in params.items()
             if k.startswith(prefix)}, x, wgrad=wgrad)
        logits.append(out)
        feature_maps.append(feats)
    return logits, feature_maps


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
