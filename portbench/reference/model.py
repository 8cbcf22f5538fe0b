"""The plain reference of the model: text encoder, duration predictor,
length regulator, mel decoder and vocoder, as functions of a state dict.

Plain PyTorch and nothing of the program: every weight is read from the
state dict the benchmark made from the seed, under the parameter names the
program's modules use, so one dict feeds both. The arithmetic follows the
published FastSpeech / HiFi-GAN-lite description of the m2-tts model:

- encoder: embedding × √d + sinusoidal position table, pre-norm
  transformer layers (fused QKV without bias, padded keys' scores replaced
  by -1e9, ReLU FFN of width 2d), final LayerNorm (eps 1e-6 everywhere);
- duration predictor: two (conv k=3 → LayerNorm → ReLU) blocks, a 1×1
  projection and softplus;
- length regulator: ``floor(duration · scale)`` frames a phoneme (padded
  phonemes give none), each frame a copy of its phoneme's encoding, zero
  past the utterance's end;
- decoder: transformer layers over every frame of the bucket, padding
  included (the model does not mask the decoder), LayerNorm, projection
  to mel;
- vocoder: conv k=3 → per rate r (tconv k=2r, stride r, pad r/2, half the
  channels → leaky ReLU 0.1 → residual block of two k=3 convs) → conv
  k=3 → tanh.

``q`` is applied to both operands of every matrix product and convolution,
``qa`` to every activation the program holds between operations in its
compute dtype (the residual stream, attention scores, norms' and
activations' outputs, durations, the mel, the vocoder's stage outputs);
both are the identity for the reference and a rounding to a lower
precision for the control (``quant.py``). Call ``exact()`` around a run on
the card so float32 products are not rounded to TF32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Q = Callable[[Tensor], Tensor]
LN_EPS = 1e-6


def _same(x: Tensor) -> Tensor:
    return x


@contextlib.contextmanager
def exact() -> Iterator[None]:
    """float32 products without TF32, restored on exit (the program runs
    with whatever the process had)."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class Sizes:
    """The model's sizes from a configuration's ``model`` section."""

    def __init__(self, model: Dict):
        te, dec, voc = model["text_encoder"], model["decoder"], model["vocoder"]
        self.vocab = int(te.get("vocab_size", 256))
        self.hidden = int(te["hidden_dim"])
        self.heads = int(te["num_heads"])
        self.enc_layers = int(te["num_layers"])
        self.dec_layers = int(dec["num_layers"])
        self.mel = int(dec["mel_channels"])
        self.channels = int(voc["hidden_channels"])
        self.rates = tuple(int(r) for r in voc["upsample_rates"])
        self.max_seq_len = int(te.get("max_seq_len", 1000))
        self.upsample = math.prod(self.rates)


def param_spec(s: Sizes) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init kind) of every weight, in the program's names.
    Kinds: 'linear' (xavier-uniform), 'conv' (normal, fan-in gain √2),
    'tconv' (normal truncated at ±2σ), 'embed' (N(0, 1)), 'ones', 'zeros'."""
    d, spec = s.hidden, []

    def ln(p):
        spec.extend([(f"{p}.weight", (d,), "ones"), (f"{p}.bias", (d,), "zeros")])

    def layer(p):
        ln(f"{p}.norm1")
        spec.extend([(f"{p}.attn.qkv.weight", (3 * d, d), "linear"),
                     (f"{p}.attn.out.weight", (d, d), "linear"),
                     (f"{p}.attn.out.bias", (d,), "zeros")])
        ln(f"{p}.norm2")
        spec.extend([(f"{p}.ffn.fc1.weight", (2 * d, d), "linear"),
                     (f"{p}.ffn.fc1.bias", (2 * d,), "zeros"),
                     (f"{p}.ffn.fc2.weight", (d, 2 * d), "linear"),
                     (f"{p}.ffn.fc2.bias", (d,), "zeros")])

    def conv(p, cout, cin, k):
        spec.extend([(f"{p}.conv.weight", (cout, cin, k), "conv"),
                     (f"{p}.conv.bias", (cout,), "zeros")])

    spec.append(("text_encoder.embedding.weight", (s.vocab, d), "embed"))
    for i in range(s.enc_layers):
        layer(f"text_encoder.layer{i}")
    ln("text_encoder.norm")
    for b in ("block1", "block2"):
        conv(f"duration_predictor.predictor.{b}.conv1d", d, d, 3)
        ln(f"duration_predictor.predictor.{b}.norm")
    conv("duration_predictor.predictor.proj", 1, d, 1)
    for i in range(s.dec_layers):
        layer(f"decoder.layer{i}")
    ln("decoder.norm")
    spec.extend([("decoder.mel_proj.weight", (s.mel, d), "linear"),
                 ("decoder.mel_proj.bias", (s.mel,), "zeros")])
    c = s.channels
    conv("vocoder.input_conv", c, s.mel, 3)
    for i, r in enumerate(s.rates):
        spec.extend([(f"vocoder.upsample{i}.weight", (c, c // 2, 2 * r), "tconv"),
                     (f"vocoder.upsample{i}.bias", (c // 2,), "zeros")])
        c //= 2
        conv(f"vocoder.resblock{i}.conv1", c, c, 3)
        conv(f"vocoder.resblock{i}.conv2", c, c, 3)
    conv("vocoder.output_conv", 1, c, 3)
    return spec


# -- blocks --------------------------------------------------------------------
def _linear(x: Tensor, w: Tensor, b: Optional[Tensor], q: Q) -> Tensor:
    return F.linear(q(x), q(w), b)


def _conv(x: Tensor, w: Tensor, b: Tensor, q: Q, dilation: int = 1) -> Tensor:
    """Conv over [B, C, T] with SAME padding."""
    pad = (w.shape[-1] - 1) * dilation // 2
    return F.conv1d(q(x), q(w), b, padding=pad, dilation=dilation)


def _ln(x: Tensor, sd: Dict[str, Tensor], p: str) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), sd[f"{p}.weight"], sd[f"{p}.bias"],
                        LN_EPS)


def _layer(x: Tensor, sd: Dict[str, Tensor], p: str, heads: int,
           mask: Optional[Tensor], q: Q, qa: Q) -> Tensor:
    B, S, d = x.shape
    hd = d // heads
    h = qa(_ln(x, sd, f"{p}.norm1"))
    qkv = qa(_linear(h, sd[f"{p}.attn.qkv.weight"], None, q))
    qkv = qkv.reshape(B, S, 3, heads, hd)
    qq, kk, vv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scores = qa(torch.matmul(q(qq), q(kk).transpose(-1, -2)) / math.sqrt(hd))
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    att = torch.matmul(q(qa(torch.softmax(scores, dim=-1))), q(vv))
    att = qa(att).transpose(1, 2).reshape(B, S, d)
    x = qa(x + qa(_linear(att, sd[f"{p}.attn.out.weight"],
                          sd[f"{p}.attn.out.bias"], q)))
    h = qa(_ln(x, sd, f"{p}.norm2"))
    h = qa(F.relu(_linear(h, sd[f"{p}.ffn.fc1.weight"],
                          sd[f"{p}.ffn.fc1.bias"], q)))
    return qa(x + qa(_linear(h, sd[f"{p}.ffn.fc2.weight"],
                             sd[f"{p}.ffn.fc2.bias"], q)))


def position_table(max_len: int, dim: int, device) -> Tensor:
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    ang = pos * div[None, :]
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : dim // 2])
    return pe


# -- the model -----------------------------------------------------------------
def encode(sd: Dict[str, Tensor], s: Sizes, ids: Tensor, lengths: Tensor,
           q: Q = _same, qa: Q = _same) -> Tuple[Tensor, Tensor]:
    """ids [B, S] int, lengths [B] → (encoding [B, S, d], mask [B, S])."""
    S = ids.shape[1]
    mask = torch.arange(S, device=ids.device)[None, :] < lengths[:, None]
    x = qa(sd["text_encoder.embedding.weight"][ids.long()]) * math.sqrt(s.hidden)
    x = qa(x + position_table(s.max_seq_len, s.hidden, ids.device)[None, :S])
    for i in range(s.enc_layers):
        x = _layer(x, sd, f"text_encoder.layer{i}", s.heads, mask, q, qa)
    return qa(_ln(x, sd, "text_encoder.norm")), mask


def durations(sd: Dict[str, Tensor], enc: Tensor, q: Q = _same,
              qa: Q = _same) -> Tensor:
    """Per-phoneme durations [B, S] (before the scale and the mask)."""
    x = enc
    for b in ("block1", "block2"):
        p = f"duration_predictor.predictor.{b}"
        h = qa(_conv(x.transpose(1, 2), sd[f"{p}.conv1d.conv.weight"],
                     sd[f"{p}.conv1d.conv.bias"], q).transpose(1, 2))
        x = qa(F.relu(_ln(h, sd, f"{p}.norm")))
    p = "duration_predictor.predictor.proj.conv"
    out = qa(_conv(x.transpose(1, 2), sd[f"{p}.weight"], sd[f"{p}.bias"], q))
    return qa(F.softplus(out[:, 0]))


def frame_counts(dur: Tensor, mask: Tensor, scale: float) -> Tensor:
    """Frames a phoneme [B, S] int64: ``floor(duration · scale)``, none for
    padded phonemes."""
    return torch.floor(dur * scale * mask.float()).clamp_min(0).long()


def regulate(enc: Tensor, frames: Tensor, max_frames: int
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """(frames [B, T, d], frame mask [B, T], total frames [B] uncapped)."""
    ends = torch.cumsum(frames, dim=1)
    t = torch.arange(max_frames, device=enc.device)
    idx = torch.searchsorted(ends, t.expand(ends.shape[0], -1).contiguous(),
                             right=True).clamp_max(enc.shape[1] - 1)
    total = ends[:, -1]
    fmask = t[None, :] < total[:, None]
    out = torch.gather(enc, 1, idx[..., None].expand(-1, -1, enc.shape[-1]))
    return out * fmask[..., None].float(), fmask, total


def decode(sd: Dict[str, Tensor], s: Sizes, x: Tensor, q: Q = _same,
           qa: Q = _same) -> Tensor:
    for i in range(s.dec_layers):
        x = _layer(x, sd, f"decoder.layer{i}", s.heads, None, q, qa)
    return qa(_linear(qa(_ln(x, sd, "decoder.norm")),
                      sd["decoder.mel_proj.weight"],
                      sd["decoder.mel_proj.bias"], q))


def vocode(sd: Dict[str, Tensor], s: Sizes, mel: Tensor, q: Q = _same,
           qa: Q = _same, taps: Optional[Dict[str, float]] = None) -> Tensor:
    """mel [B, T, C] → audio [B, T · upsample] in [-1, 1]. ``taps``, where
    given, gets the RMS of each biased layer's output by its bias's name."""
    def tap(name: str, x: Tensor) -> Tensor:
        if taps is not None:
            taps[name] = float(x.float().pow(2).mean().sqrt())
        return x

    x = qa(tap("vocoder.input_conv.conv.bias", _conv(
        mel.transpose(1, 2), sd["vocoder.input_conv.conv.weight"],
        sd["vocoder.input_conv.conv.bias"], q)))
    for i, r in enumerate(s.rates):
        x = tap(f"vocoder.upsample{i}.bias", F.conv_transpose1d(
            q(x), q(sd[f"vocoder.upsample{i}.weight"]),
            sd[f"vocoder.upsample{i}.bias"], stride=r, padding=r // 2))
        x = qa(F.leaky_relu(x, 0.1))
        p = f"vocoder.resblock{i}"
        h = qa(F.leaky_relu(tap(f"{p}.conv1.conv.bias", _conv(
            x, sd[f"{p}.conv1.conv.weight"], sd[f"{p}.conv1.conv.bias"], q)),
            0.1))
        x = qa(x + tap(f"{p}.conv2.conv.bias", _conv(
            h, sd[f"{p}.conv2.conv.weight"], sd[f"{p}.conv2.conv.bias"], q)))
    x = tap("vocoder.output_conv.conv.bias", _conv(
        x, sd["vocoder.output_conv.conv.weight"],
        sd["vocoder.output_conv.conv.bias"], q))
    return torch.tanh(x[:, 0])


def mel_for(sd: Dict[str, Tensor], s: Sizes, ids: Tensor, lengths: Tensor,
            scale: float, max_frames: int, q: Q = _same, qa: Q = _same
            ) -> Tuple[Tensor, Tensor]:
    """The acoustic path at one frame bucket: (mel [B, T, C] zeroed past each
    utterance's end, total frames [B] uncapped)."""
    enc, mask = encode(sd, s, ids, lengths, q, qa)
    frames = frame_counts(durations(sd, enc, q, qa), mask, scale)
    x, fmask, total = regulate(enc, frames, max_frames)
    mel = qa(decode(sd, s, x, q, qa)) * fmask[..., None].float()
    return mel, total


def totals(sd: Dict[str, Tensor], s: Sizes, ids: Tensor, lengths: Tensor,
           scale: float) -> Tensor:
    """Total frames [B] of each utterance by the float32 duration probe."""
    enc, mask = encode(sd, s, ids, lengths)
    return frame_counts(durations(sd, enc), mask, scale).sum(dim=1)


def pcm16(audio: Tensor) -> Tensor:
    """[-1, 1] audio → int16 PCM (×32767, truncated toward zero)."""
    return (torch.clamp(audio.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
