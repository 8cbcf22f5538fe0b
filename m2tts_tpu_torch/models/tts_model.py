"""M2TTS in PyTorch: text encoder → duration predictor → length regulator
→ mel decoder → HiFi-GAN-lite vocoder.

Counterpart of ``m2tts_tpu/models/tts_model.py``, with the same submodule
names as the flax param tree. Every stage runs at a fixed shape chosen by
the caller (``max_frames``), so one frame bucket is one set of shapes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from m2tts_tpu_torch.models.components import (
    LN_EPS,
    Conv1d,
    ConvBlock,
    ConvTranspose1d,
    Dropout,
    LightweightResBlock,
    TransformerEncoderLayer,
    VariancePredictor,
    padding_mask,
    sinusoidal_position_encoding,
)
from m2tts_tpu_torch.ops.length_regulator import regulate_lengths
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.device import resolve_device


class TextEncoder(nn.Module):
    """Embedding (×√d) + sinusoidal PE + N pre-norm transformer layers + LN."""

    def __init__(self, vocab_size: int = 256, hidden_dim: int = 64,
                 num_layers: int = 2, num_heads: int = 2,
                 dropout_rate: float = 0.1, max_seq_len: int = 1000):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.max_seq_len = max_seq_len
        self.num_layers = num_layers
        self.embedding = nn.Embedding(vocab_size, hidden_dim)
        self.dropout = Dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                hidden_dim, num_heads, hidden_dim * 2, dropout_rate))
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, phoneme_ids: torch.Tensor,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        B, S = phoneme_ids.shape
        mask = padding_mask(lengths, S) if lengths is not None else None
        x = self.embedding(phoneme_ids.long())
        x = x * torch.tensor(self.hidden_dim ** 0.5, dtype=x.dtype)
        pe = sinusoidal_position_encoding(self.max_seq_len, self.hidden_dim,
                                          x.dtype, x.device)
        x = self.dropout(x + pe[None, :S])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, mask)
        return self.norm(x), mask


class DurationPredictor(nn.Module):
    """VariancePredictor + softplus → positive per-phoneme durations."""

    def __init__(self, hidden_dim: int = 64, kernel_size: int = 3,
                 dropout_rate: float = 0.1, norm: str = "layer"):
        super().__init__()
        self.predictor = VariancePredictor(hidden_dim, kernel_size,
                                           dropout_rate, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.softplus(self.predictor(x))


class MelDecoder(nn.Module):
    """N transformer layers + LN + linear projection to mel channels."""

    def __init__(self, hidden_dim: int = 64, mel_channels: int = 64,
                 num_layers: int = 2, num_heads: int = 2,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                hidden_dim, num_heads, hidden_dim * 2, dropout_rate))
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.mel_proj = nn.Linear(hidden_dim, mel_channels)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, mask)
        return self.mel_proj(self.norm(x))


class Vocoder(nn.Module):
    """conv-in → (tconv ↑r, ½ channels → leaky → resblock)× → tanh out.
    [B, T, mel] → [B, T·prod(rates), 1]."""

    def __init__(self, mel_channels: int = 64, hidden_channels: int = 128,
                 kernel_size: int = 3,
                 upsample_rates: Sequence[int] = (4, 4, 2, 2)):
        super().__init__()
        for r in upsample_rates:
            if r % 2:
                # (k=2r, s=r, p=r//2) maps L frames to exactly L*r only for
                # even r; an odd rate would desync every trim boundary and
                # the packed-weight vocoders
                raise ValueError(
                    f"vocoder upsample_rates must be even, got {r} in "
                    f"{tuple(upsample_rates)}")
        self.upsample_rates = tuple(upsample_rates)
        self.input_conv = Conv1d(mel_channels, hidden_channels, kernel_size)
        ch = hidden_channels
        for i, rate in enumerate(self.upsample_rates):
            self.add_module(f"upsample{i}", ConvTranspose1d(
                ch, ch // 2, kernel_size=rate * 2, stride=rate,
                padding=rate // 2))
            ch //= 2
            self.add_module(f"resblock{i}",
                            LightweightResBlock(ch, kernel_size))
        self.output_conv = Conv1d(ch, 1, kernel_size)

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.input_conv(mel)
        for i in range(len(self.upsample_rates)):
            x = F.leaky_relu(getattr(self, f"upsample{i}")(x),
                             negative_slope=0.1)
            x = getattr(self, f"resblock{i}")(x)
        return torch.tanh(self.output_conv(x))


class M2TTS(nn.Module):
    """Full text→mel→waveform model.

    ``forward`` runs the acoustic path (the vocoder only with
    ``run_vocoder``); ``synthesize`` runs the full inference path with
    duration scaling before rounding.
    """

    def __init__(self, vocab_size: int = 256, hidden_dim: int = 64,
                 mel_channels: int = 64, text_encoder_layers: int = 2,
                 decoder_layers: int = 2, num_heads: int = 2,
                 dropout_rate: float = 0.1, vocoder_channels: int = 128,
                 upsample_rates: Sequence[int] = (4, 4, 2, 2),
                 duration_norm: str = "layer", max_seq_len: int = 1000,
                 mask_decoder: bool = False):
        super().__init__()
        self.mel_channels = mel_channels
        self.vocoder_channels = vocoder_channels
        self.upsample_rates = tuple(upsample_rates)
        # the decoder attends over padding frames unmasked by default,
        # as the JAX model does
        self.mask_decoder = mask_decoder
        self.text_encoder = TextEncoder(vocab_size, hidden_dim,
                                        text_encoder_layers, num_heads,
                                        dropout_rate, max_seq_len)
        self.duration_predictor = DurationPredictor(hidden_dim, 3,
                                                    dropout_rate,
                                                    duration_norm)
        self.decoder = MelDecoder(hidden_dim, mel_channels, decoder_layers,
                                  num_heads, dropout_rate)
        self.vocoder = Vocoder(mel_channels, vocoder_channels, 3,
                               self.upsample_rates)

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates)

    def forward(self, phoneme_ids: torch.Tensor,
                phoneme_lengths: Optional[torch.Tensor] = None,
                target_durations: Optional[torch.Tensor] = None,
                max_frames: int = 1000,
                run_vocoder: bool = False) -> Dict[str, Any]:
        enc, mask = self.text_encoder(phoneme_ids, phoneme_lengths)
        duration_pred = self.duration_predictor(enc)
        if target_durations is not None:
            durations = target_durations
        elif mask is not None:
            # padded phonemes contribute zero frames, so the text bucket a
            # request lands in does not change its output length
            durations = duration_pred * mask.to(duration_pred.dtype)
        else:
            durations = duration_pred
        regulated, frame_mask, total_frames = regulate_lengths(
            enc, durations, max_frames)
        mel = self.decoder(regulated, frame_mask if self.mask_decoder else None)
        audio = self.vocoder(mel) if run_vocoder else None
        return {
            "encoder_output": enc,
            "duration_pred": duration_pred,
            "regulated_output": regulated,
            "mel_output": mel,
            "audio_output": audio,
            "padding_mask": mask,
            "frame_mask": frame_mask,
            "total_frames": total_frames,
        }

    def acoustic(self, phoneme_ids: torch.Tensor,
                 phoneme_lengths: Optional[torch.Tensor] = None,
                 duration_scale=1.0,
                 max_frames: int = 1000) -> Dict[str, Any]:
        """Inference acoustic path: text → mel zeroed past each utterance's
        total frames (no vocoder)."""
        enc, mask = self.text_encoder(phoneme_ids, phoneme_lengths)
        duration_pred = self.duration_predictor(enc)
        scaled = duration_pred * torch.as_tensor(
            duration_scale, dtype=duration_pred.dtype,
            device=duration_pred.device)
        if mask is not None:  # padded phonemes contribute zero frames
            scaled = scaled * mask.to(scaled.dtype)
        regulated, frame_mask, total_frames = regulate_lengths(
            enc, scaled, max_frames)
        mel = self.decoder(regulated, frame_mask if self.mask_decoder else None)
        # zero mel past each utterance's end so bucket padding cannot bleed
        # through the vocoder's receptive field into the real audio's tail
        mel = mel * frame_mask[..., None].to(mel.dtype)
        return {
            "mel_output": mel,
            "duration_pred": duration_pred,
            "frame_mask": frame_mask,
            "total_frames": total_frames,
        }

    def synthesize(self, phoneme_ids: torch.Tensor,
                   phoneme_lengths: Optional[torch.Tensor] = None,
                   duration_scale=1.0,
                   max_frames: int = 1000) -> Dict[str, Any]:
        """Full inference: acoustic path + vocoder."""
        out = self.acoustic(phoneme_ids, phoneme_lengths, duration_scale,
                            max_frames)
        out["audio_output"] = self.vocoder(out["mel_output"])
        out["audio_samples"] = out["total_frames"] * self.total_upsample
        return out


def build_model(model_cfg) -> M2TTS:
    """M2TTS from a config's ``model`` section (a ``Config`` or a dict)."""
    cfg = model_cfg if isinstance(model_cfg, Config) else Config(model_cfg)
    g = cfg.get
    return M2TTS(
        vocab_size=g("text_encoder.vocab_size", 256),
        hidden_dim=g("text_encoder.hidden_dim", 64),
        text_encoder_layers=g("text_encoder.num_layers", 2),
        num_heads=g("text_encoder.num_heads", 2),
        dropout_rate=g("text_encoder.dropout", 0.1),
        mel_channels=g("decoder.mel_channels", 64),
        decoder_layers=g("decoder.num_layers", 2),
        vocoder_channels=g("vocoder.hidden_channels", 128),
        upsample_rates=tuple(g("vocoder.upsample_rates", (4, 4, 2, 2))),
        duration_norm=g("duration_predictor.norm", "layer"),
        max_seq_len=g("text_encoder.max_seq_len", 1000),
    )


@torch.no_grad()
def init_params(model: M2TTS, generator: torch.Generator,
                device="cuda") -> M2TTS:
    """Initialise ``model`` in place from ``generator`` (a CPU generator),
    move it to ``device`` and put it in eval mode; returns the model.

    Follows the JAX init table: xavier-uniform Linear weights, untruncated
    kaiming-normal (fan_in, gain √2) conv weights, N(0, 1) embeddings,
    zero biases, LayerNorm ones/zeros, and lecun-normal (truncated at ±2σ,
    fan_in = in·out as flax counts it for an (in, out, k) kernel) for the
    transposed convs. BatchNorm-compat params start as the identity.
    """
    dev = resolve_device(device)
    model.to("cpu")
    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear):
            torch.nn.init.xavier_uniform_(mod.weight, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, torch.nn.Conv1d):
            std = math.sqrt(2.0 / (mod.weight.shape[1] * mod.weight.shape[2]))
            mod.weight.normal_(0.0, std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, ConvTranspose1d):
            cin, cout, _ = mod.weight.shape
            # flax truncated_normal: unit-variance after truncation
            std = math.sqrt(1.0 / (cin * cout)) / 0.87962566103423978
            torch.nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                        2 * std, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, torch.nn.Embedding):
            mod.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(mod, torch.nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, ConvBlock) and mod.norm_kind == "batch":
            mod.bn_mean.zero_()
            mod.bn_var.fill_(1.0)
            mod.bn_scale.fill_(1.0)
            mod.bn_bias.zero_()
    return model.to(dev).eval()
