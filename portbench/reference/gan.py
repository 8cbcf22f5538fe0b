"""The plain float32 reference of one stage-2 GAN step: the generator in
train mode, the multi-scale discriminator with spectral norm, every loss
term of the quality recipe, clip-by-global-norm AdamW for both nets, the
discriminator's update guard and the generator's EMA.

Plain PyTorch, importing nothing of the program, with no graphs and no
foreach calls. Weights are read by the program's parameter names, so one
dict feeds both. The arithmetic follows the stage-2 recipe of the m2-tts
model, step by step as the fused step orders it:

1. the fake: the generator forward in train mode (dropout on) on the
   step's batch, teacher-forced (``floor`` of the target durations a
   phoneme), the decoder's mel cut to each row's window of ``seg_frames``
   frames and vocoded;
2. the discriminator step: the LSGAN loss of the multi-scale
   discriminator on ``[real; fake]`` (the fake a constant), its gradient
   over the discriminator's weights, clipped by global norm, AdamW, the
   applied change scaled by ``clip(d_loss / d_floor, 0, 1)``;
3. the generator step against the updated discriminator: masked mel L1,
   duration MSE, multi-resolution STFT magnitude L1, log-mel L1 and the
   envelope correlation loss, the LSGAN generator loss and feature
   matching (real features constants), the adversarial and feature-
   matching weights times the warmup ramp ``clip(g_updates / warmup, 0,
   1)``, the adversarial one also times ``clip(d_loss / adv_floor, 0,
   1)``; its gradient over the generator's weights, clipped, AdamW, then
   the EMA ``e ← decay · e + (1 − decay) · p``.

Dropout draws its uniforms from a ``torch.Generator`` seeded with the
step's dropout seed, one ``torch.rand`` of the activation's shape a
dropout, in the model's order (the embedding sum; per transformer layer
the attention weights, the attention output, the FFN's hidden layer and
the FFN output; the duration predictor's two blocks; the decoder's
layers), and keeps an element where the uniform is at least the rate.
The row windows are ``floor(u · (max(mel_length − seg_frames, 0) + 1))``
for ``u`` one uniform a row from a generator seeded with the offsets
seed. Both seeds are the step's inputs, as the batch is.

``q`` and ``qa`` (``quant.py``) round the operands of every product and
every activation the program holds in bfloat16 (both nets' forwards); the
losses, gradients and optimizers stay float32, as the program keeps them.
For the control, ``qa`` also rounds each activation's gradient on the way
back (``rounded``), as a bfloat16 backward holds it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model as ref

Tensor = torch.Tensor
Q = Callable[[Tensor], Tensor]
Params = Dict[str, Tensor]

#: (features, kernel, stride, groups) of each conv of one scale
D_LAYERS = ((64, 15, 1, 1), (128, 41, 4, 4), (256, 41, 4, 16),
            (512, 41, 4, 64), (1024, 41, 4, 256), (1024, 5, 1, 1))
D_SCALES = (1, 2, 4)  # average pooling of each scale's input
D_LEAK = 0.2
SN_ITERS = 3  # power iterations of the spectral norm
STFT_RESOLUTIONS = (512, 1024, 2048)
ADAM_EPS = 1e-8


def _same(x: Tensor) -> Tensor:
    return x


class _RoundBoth(torch.autograd.Function):
    """An activation rounded on the way forward and its gradient on the
    way back, by the same rounding."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounded(fn: Q) -> Q:
    """``fn`` as an activation rounding of a training step: the forward
    value and the backward gradient both rounded, straight through."""
    return lambda x: _RoundBoth.apply(x, fn)


def _straight(fn: Q) -> Q:
    """``fn`` as an operand rounding: the value rounded, the gradient
    passed through."""
    return lambda x: x + (fn(x) - x).detach()


def control_roundings(name: str) -> Tuple[Q, Q]:
    """(operand rounding, activation rounding) of a training control from
    ``quant.ROUNDINGS``: operands rounded straight through, activations
    and their gradients rounded both ways."""
    from portbench.reference.quant import ROUNDINGS

    q, qa = ROUNDINGS[name]
    return _straight(q), rounded(qa)


# -- the recipe ------------------------------------------------------------------
class Recipe:
    """The numbers of a stage-2 step from a ``training`` section."""

    def __init__(self, t: Dict, upsample: int, sample_rate: int, n_mels: int):
        g = t.get  # a key the section leaves out takes the recipe's default
        self.seg_frames = max(int(g("audio_segment_len", 8192)) // upsample,
                              8)
        self.upsample = upsample
        self.sample_rate = sample_rate  # the vocoder's output rate
        self.n_mels = n_mels
        self.w = {"mel": float(g("mel_loss_weight", 1.0)),
                  "duration": float(g("duration_loss_weight", 0.1)),
                  "adversarial": float(g("adversarial_loss_weight", 0.25)),
                  "feature_matching": float(g("feature_matching_weight", 2.0)),
                  "spectral": float(g("spectral_loss_weight", 1.0)),
                  "perceptual": float(g("perceptual_loss_weight", 0.5)),
                  "envelope": float(g("envelope_loss_weight", 0.0))}
        self.phase_weight = float(g("stft_phase_weight", 0.1))
        self.adv_warmup = int(g("adversarial_warmup_steps", 0))
        self.adv_floor = float(g("adaptive_adv_dloss_floor", 0.0))
        self.d_floor = float(g("adaptive_d_lr_floor", 0.0))
        self.ema_decay = float(g("ema_decay", 0.0))
        self.clip = float(g("gradient_clip_norm", 1.0))
        self.b1, self.b2 = float(g("adam_b1", 0.8)), float(g("adam_b2", 0.99))
        self.wd = float(g("weight_decay", 1e-6))
        self.lr = float(g("learning_rate", 1e-4))
        self.warmup = max(int(g("warmup_steps", 0)), 1)
        self.max_steps = int(g("max_steps", 50000))
        self.dropout = 0.1
        if g("lr_scheduler", "cosine") != "cosine" or g(
                "alternate_gd", False) or int(g(
                    "gradient_accumulation_steps", 1)) != 1:
            raise ValueError("the reference knows the fused step with the "
                             "cosine schedule, one micro-step an update")

    def lr_at(self, count: int) -> float:
        """The warmup-cosine schedule (from 0 to the peak over ``warmup``
        applied updates, then a cosine to 0 at ``max_steps``), in float32
        as the schedule's published form computes it."""
        f = np.float32
        if count < self.warmup:
            frac = f(1) - f(min(max(count, 0), self.warmup)) / f(self.warmup)
            return float(f(-self.lr) * frac + f(self.lr))
        span = max(self.max_steps, self.warmup + 1) - self.warmup
        c = f(min(count - self.warmup, span))
        return float(f(self.lr) * f(0.5) * (f(1) + np.cos(f(math.pi) * c
                                                           / f(span))))

    def ramp(self, g_updates: int) -> float:
        if self.adv_warmup <= 0:
            return 1.0
        return float(np.clip(np.float32(g_updates) / np.float32(
            self.adv_warmup), 0.0, 1.0))


# -- the discriminator -----------------------------------------------------------
def disc_param_spec() -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init kind) of the discriminator's weights, in the
    program's names."""
    spec = []
    for i in range(len(D_SCALES)):
        cin = 1
        for j, (ch, k, _, g) in enumerate(D_LAYERS):
            spec += [(f"scale{i}.conv{j}.conv.weight", (ch, cin // g, k),
                      "conv"), (f"scale{i}.conv{j}.conv.bias", (ch,), "zeros")]
            cin = ch
        spec += [(f"scale{i}.conv_out.conv.weight", (1, cin, 3), "conv"),
                 (f"scale{i}.conv_out.conv.bias", (1,), "zeros")]
    return spec


def spectral_normalize(w: Tensor) -> Tensor:
    """``w`` over its largest singular value (dim 0 the output): power
    iteration from the uniform start ``1/√out``, eps 1e-12 beside every
    norm, differentiated through."""
    mat = w.reshape(w.shape[0], -1).t()
    v = torch.full((mat.shape[1],), 1.0 / math.sqrt(mat.shape[1]),
                   dtype=w.dtype, device=w.device)
    for _ in range(SN_ITERS):
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        v = mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    sigma = u @ (mat @ v)
    return w / (sigma + 1e-12)


def _disc_scale(p: Params, pre: str, x: Tensor, q: Q, qa: Q,
                spectral: bool, taps: Optional[Dict[str, float]] = None
                ) -> Tuple[Tensor, List[Tensor]]:
    """One scale on [B, T] audio → (logits [B, T'], six pre-activation
    feature maps [B, C, T_j])."""
    def weight(name):
        w = p[name]
        return qa(spectral_normalize(q(w))) if spectral else q(w)

    def conv(h, name, stride, groups):
        w = weight(f"{pre}{name}.conv.weight")
        out = F.conv1d(q(h), w, p[f"{pre}{name}.conv.bias"], stride=stride,
                       padding=(w.shape[-1] - 1) // 2, groups=groups)
        if taps is not None:
            taps[f"{pre}{name}.conv.bias"] = float(out.pow(2).mean().sqrt())
        return out

    feats = []
    h = x[:, None, :]
    for j, (_, _, s, g) in enumerate(D_LAYERS):
        h = qa(conv(h, f"conv{j}", s, g))
        feats.append(h)
        h = qa(F.leaky_relu(h, D_LEAK))
    return qa(conv(h, "conv_out", 1, 1))[:, 0], feats


def discriminate(p: Params, audio: Tensor, q: Q = _same, qa: Q = _same,
                 spectral: bool = True,
                 taps: Optional[Dict[str, float]] = None
                 ) -> Tuple[List[Tensor], List[List[Tensor]]]:
    """The multi-scale discriminator on [B, T] audio: per scale (the input
    average-pooled by 1, 2, 4, the remainder dropped) its logits and
    feature maps."""
    logits, feats = [], []
    x0 = qa(audio)
    for i, f in enumerate(D_SCALES):
        x = x0
        if f > 1:
            T = (x0.shape[1] // f) * f
            x = qa(x0[:, :T].reshape(x0.shape[0], T // f, f).mean(-1))
        lg, ft = _disc_scale(p, f"scale{i}.", x, q, qa, spectral, taps)
        logits.append(lg)
        feats.append(ft)
    return logits, feats


# -- the generator in train mode -------------------------------------------------
class Dropout:
    """Inverted dropout whose uniforms come, in call order, from one
    generator seeded with the step's dropout seed."""

    def __init__(self, seed: int, device, rate: float):
        self.g = torch.Generator(device=device)
        self.g.manual_seed(int(seed))
        self.rate, self.device = rate, device

    def __call__(self, x: Tensor) -> Tensor:
        u = torch.rand(x.shape, generator=self.g, device=self.device)
        return torch.where(u >= self.rate, x / (1.0 - self.rate),
                           torch.zeros_like(x))


def _layer(x: Tensor, sd: Params, p: str, heads: int, mask, q: Q, qa: Q,
           drop) -> Tensor:
    """A pre-norm transformer layer in train mode (``model._layer`` with
    its four dropouts)."""
    B, S, d = x.shape
    hd = d // heads
    h = qa(ref._ln(x, sd, f"{p}.norm1"))
    qkv = qa(ref._linear(h, sd[f"{p}.attn.qkv.weight"], None, q))
    qkv = qkv.reshape(B, S, 3, heads, hd)
    qq, kk, vv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scores = qa(torch.matmul(q(qq), q(kk).transpose(-1, -2)) / math.sqrt(hd))
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    att = qa(drop(qa(torch.softmax(scores, dim=-1))))
    att = qa(torch.matmul(q(att), q(vv))).transpose(1, 2).reshape(B, S, d)
    x = qa(x + qa(drop(qa(ref._linear(att, sd[f"{p}.attn.out.weight"],
                                      sd[f"{p}.attn.out.bias"], q)))))
    h = qa(ref._ln(x, sd, f"{p}.norm2"))
    h = qa(drop(qa(F.relu(ref._linear(h, sd[f"{p}.ffn.fc1.weight"],
                                      sd[f"{p}.ffn.fc1.bias"], q)))))
    return qa(x + qa(drop(qa(ref._linear(h, sd[f"{p}.ffn.fc2.weight"],
                                         sd[f"{p}.ffn.fc2.bias"], q)))))


def generate(sd: Params, s: ref.Sizes, batch: Dict[str, Tensor],
             offsets: Tensor, seg_frames: int, drop, q: Q = _same,
             qa: Q = _same) -> Tuple[Tensor, Tensor, Tensor]:
    """The teacher-forced generator in train mode: (mel [B, T, C],
    durations [B, S], audio of each row's window [B, seg_frames · U])."""
    ids, lengths = batch["phoneme_ids"], batch["text_lengths"]
    S = ids.shape[1]
    mask = torch.arange(S, device=ids.device)[None, :] < lengths[:, None]
    x = qa(sd["text_encoder.embedding.weight"][ids.long()]) * math.sqrt(
        s.hidden)
    x = qa(drop(qa(x + ref.position_table(s.max_seq_len, s.hidden,
                                          ids.device)[None, :S])))
    for i in range(s.enc_layers):
        x = _layer(x, sd, f"text_encoder.layer{i}", s.heads, mask, q, qa,
                   drop)
    enc = qa(ref._ln(x, sd, "text_encoder.norm"))
    h = enc
    for b in ("block1", "block2"):
        p = f"duration_predictor.predictor.{b}"
        c = qa(ref._conv(h.transpose(1, 2), sd[f"{p}.conv1d.conv.weight"],
                         sd[f"{p}.conv1d.conv.bias"], q).transpose(1, 2))
        h = qa(drop(qa(F.relu(qa(ref._ln(c, sd, f"{p}.norm"))))))
    p = "duration_predictor.predictor.proj.conv"
    dur = qa(F.softplus(qa(ref._conv(h.transpose(1, 2), sd[f"{p}.weight"],
                                     sd[f"{p}.bias"], q))[:, 0]))
    T = batch["mel"].shape[1]
    frames = torch.floor(batch["durations"]).clamp_min(0).long()
    x, _, _ = ref.regulate(enc, frames, T)
    x = qa(x)
    for i in range(s.dec_layers):
        x = _layer(x, sd, f"decoder.layer{i}", s.heads, None, q, qa, drop)
    mel = qa(ref._linear(qa(ref._ln(x, sd, "decoder.norm")),
                         sd["decoder.mel_proj.weight"],
                         sd["decoder.mel_proj.bias"], q))
    start = offsets.long().clamp(0, max(T - seg_frames, 0))
    rows = start[:, None] + torch.arange(seg_frames, device=start.device)
    seg = torch.gather(mel, 1, rows[..., None].expand(-1, -1, mel.shape[-1]))
    return mel, dur, ref.vocode(sd, s, seg, q, qa)


def window(batch: Dict[str, Tensor], seed: int, seg_frames: int,
           upsample: int, dtype: torch.dtype = torch.float32
           ) -> Tuple[Tensor, Tensor]:
    """(frame offsets [B] int32, target audio [B, seg_frames · U] in
    ``dtype``) of the step's windows of the full waveforms."""
    mel_len = batch["mel_lengths"]
    g = torch.Generator(device=mel_len.device)
    g.manual_seed(int(seed))
    u = torch.rand((mel_len.shape[0],), generator=g, device=mel_len.device)
    max_off = torch.clamp(mel_len - seg_frames, min=0)
    offsets = torch.floor(u * (max_off + 1).float()).to(torch.int32)
    audio = batch["audio"].to(dtype)
    S = seg_frames * upsample
    start = (offsets.long() * upsample).clamp(max=audio.shape[1] - S)
    cols = start[:, None] + torch.arange(S, device=start.device)
    return offsets, torch.gather(audio, 1, cols)


# -- losses ------------------------------------------------------------------------
def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 200.0 / 3
    return np.where(f >= 1000.0, 1000.0 / lin + np.log(np.maximum(f, 1e-10)
                                                         / 1000.0)
                    / (np.log(6.4) / 27.0), f / lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = 200.0 / 3
    return np.where(m >= 1000.0 / lin, 1000.0 * np.exp(
        np.log(6.4) / 27.0 * (m - 1000.0 / lin)), m * lin)


def mel_basis(sr: int, n_fft: int, n_mels: int, device,
              dtype: torch.dtype = torch.float32) -> Tensor:
    """The Slaney-scale, Slaney-normalised triangular filterbank
    [n_mels, n_fft/2 + 1] from 0 Hz to sr/2."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                 n_mels + 2))
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / np.diff(pts)[:-1, None]
    upper = ramps[2:] / np.diff(pts)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return torch.from_numpy(w).to(device, dtype)


def spectrum(x: Tensor, n_fft: int, hop: int) -> Tensor:
    """Centred (reflect-padded) STFT with a periodic Hann window:
    [B, frames, n_fft/2 + 1]."""
    w = torch.hann_window(n_fft, periodic=True, dtype=torch.float64).to(
        x.device, x.dtype)
    return torch.stft(x, n_fft, hop, window=w, center=True,
                      pad_mode="reflect", return_complex=True).transpose(1, 2)


def losses_of(mel: Tensor, dur: Tensor, audio: Tensor, target: Tensor,
              batch: Dict[str, Tensor], r: Recipe) -> Dict[str, Tensor]:
    """The generator's reconstruction terms (in the audio's type)."""
    T = mel.shape[1]
    m = (torch.arange(T, device=mel.device)[None, :]
         < batch["mel_lengths"][:, None]).float()
    per = ((mel - batch["mel"]).abs().mean(-1) * m).sum(1) / m.sum(1).clamp(
        min=1.0)
    out = {"mel_loss": per.mean(),
           "duration_loss": ((dur - batch["durations"]) ** 2).mean()}
    spec = 0.0
    for n in STFT_RESOLUTIONS:
        sp, st = spectrum(audio, n, n // 4), spectrum(target, n, n // 4)
        spec = spec + (sp.abs() - st.abs()).abs().mean()
        if r.phase_weight:
            spec = spec + r.phase_weight * (torch.angle(sp + 0.0)
                                            - torch.angle(st + 0.0)
                                            ).abs().mean()
    out["spectral_loss"] = spec / len(STFT_RESOLUTIONS)
    basis = mel_basis(r.sample_rate, 1024, r.n_mels, mel.device,
                      audio.dtype)

    def logmel(x):
        return torch.log(torch.einsum("btf,mf->btm",
                                      spectrum(x, 1024, 256).abs(), basis)
                         + 1e-8)
    out["perceptual_loss"] = (logmel(audio) - logmel(target)).abs().mean()
    if r.w["envelope"] > 0:
        eb = mel_basis(r.sample_rate, 512, 16, mel.device, audio.dtype)

        def env(x):
            sp = spectrum(x, 512, 128)
            return torch.sqrt(torch.einsum("btf,mf->btm",
                                           sp.real ** 2 + sp.imag ** 2, eb)
                              + 1e-8)
        ep, et = env(audio), env(target)
        ep = ep - ep.mean(1, keepdim=True)
        et = et - et.mean(1, keepdim=True)
        den = torch.sqrt(((ep ** 2).sum(1) + 1e-8) * ((et ** 2).sum(1) + 1e-8))
        out["envelope_loss"] = 1.0 - ((ep * et).sum(1) / den).mean()
    return out


def lsgan_d(real: List[Tensor], fake: List[Tensor]) -> Tensor:
    return (sum(((r - 1.0) ** 2).mean() for r in real)
            + sum((f ** 2).mean() for f in fake)) / len(real)


def lsgan_g(fake: List[Tensor]) -> Tensor:
    return sum(((f - 1.0) ** 2).mean() for f in fake) / len(fake)


def feature_matching(real: List[List[Tensor]], fake: List[List[Tensor]]
                     ) -> Tensor:
    total = 0.0
    for rs, fs in zip(real, fake):
        for r, f in zip(rs, fs):
            total = total + (f - r).abs().mean()
    return total / (len(real) * len(real[0]))


# -- the optimizer ------------------------------------------------------------------
def clipped(grads: Params, max_norm: float) -> Params:
    """Clip by global norm: every gradient times max_norm / norm where the
    norm is at least max_norm."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())
                      ).float()
    if float(norm) < max_norm:
        return dict(grads)
    return {k: g / norm * max_norm for k, g in grads.items()}


class Adam:
    """AdamW's state of one net: the moments by name and the applied
    updates so far."""

    def __init__(self, m: Params, v: Params, count: int):
        self.m, self.v, self.count = m, v, int(count)

    @classmethod
    def zeros(cls, params: Params) -> "Adam":
        return cls({k: torch.zeros_like(p) for k, p in params.items()},
                   {k: torch.zeros_like(p) for k, p in params.items()}, 0)


@torch.no_grad()
def adamw(params: Params, grads: Params, st: Adam, r: Recipe,
          scale: Optional[Tensor] = None) -> Tuple[Params, Adam]:
    """One applied update: decoupled weight decay, the moments, the bias-
    corrected step at the schedule's lr; ``scale`` multiplies the applied
    change (the moments advance as without it)."""
    lr = r.lr_at(st.count)
    t = st.count + 1
    bc1, bc2 = 1 - r.b1 ** t, 1 - r.b2 ** t
    new, m, v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m[k] = r.b1 * st.m[k] + (1 - r.b1) * g
        v[k] = r.b2 * st.v[k] + (1 - r.b2) * g * g
        step = p * (1 - lr * r.wd) - (lr / bc1) * m[k] / (
            v[k].sqrt() / math.sqrt(bc2) + ADAM_EPS)
        new[k] = step if scale is None else p + scale * (step - p)
    return new, Adam(m, v, t)


# -- the step --------------------------------------------------------------------
class State:
    """Both nets, both optimizers, the EMA and the generator's update
    count (the ramp's clock)."""

    def __init__(self, g: Params, d: Params, g_opt: Adam, d_opt: Adam,
                 ema: Optional[Params], g_updates: int):
        self.g, self.d, self.g_opt, self.d_opt = g, d, g_opt, d_opt
        self.ema, self.g_updates = ema, int(g_updates)

    @classmethod
    def start(cls, g: Params, d: Params, ema: bool) -> "State":
        return cls(dict(g), dict(d), Adam.zeros(g), Adam.zeros(d),
                   dict(g) if ema else None, 0)


def step(st: State, s: ref.Sizes, r: Recipe, batch: Dict[str, Tensor],
         drop_seed: int, offsets_seed: int, q: Q = _same, qa: Q = _same,
         spectral: bool = True) -> Tuple[State, Dict[str, float],
                                         Dict[str, Params]]:
    """One fused GAN step from ``st``: (the new state, the losses as the
    step reports them, the clipped gradients of both nets by name)."""
    offsets, target = window(batch, offsets_seed, r.seg_frames, r.upsample,
                             next(iter(st.g.values())).dtype)
    g = {k: v.detach().requires_grad_(True) for k, v in st.g.items()}
    d = {k: v.detach().requires_grad_(True) for k, v in st.d.items()}
    # one generator forward serves both steps: the discriminator step reads
    # its audio as a constant, and the generator is not updated between
    mel, dur, fake = generate(g, s, batch, offsets, r.seg_frames,
                              Dropout(drop_seed, target.device, r.dropout),
                              q, qa)
    B = target.shape[0]
    logits, _ = discriminate(d, torch.cat([target, fake.detach()]), q, qa,
                             spectral)
    d_loss = lsgan_d([l[:B] for l in logits], [l[B:] for l in logits])
    d_grads = clipped(dict(zip(d, torch.autograd.grad(d_loss, list(
        d.values()))), ), r.clip)
    d_loss = d_loss.detach()
    guard = torch.clamp(d_loss / r.d_floor, 0.0, 1.0) if r.d_floor > 0 \
        else None
    d_new, d_opt = adamw(st.d, d_grads, st.d_opt, r, guard)

    losses = losses_of(mel, dur, fake, target, batch, r)
    dd = {k: v.detach() for k, v in d_new.items()}
    fl, ff = discriminate(dd, fake, q, qa, spectral)
    with torch.no_grad():
        _, rf = discriminate(dd, target, q, qa, spectral)
    losses["generator_loss"] = lsgan_g(fl)
    losses["feature_matching_loss"] = feature_matching(rf, ff)
    ramp = r.ramp(st.g_updates)
    adv_w = r.w["adversarial"] * ramp
    fm_w = r.w["feature_matching"] * ramp
    if r.adv_floor > 0:
        losses["adv_guard"] = torch.clamp(d_loss / r.adv_floor, 0.0, 1.0)
        adv_w = adv_w * losses["adv_guard"]
    total = (r.w["mel"] * losses["mel_loss"]
             + r.w["duration"] * losses["duration_loss"]
             + r.w["spectral"] * losses["spectral_loss"]
             + r.w["perceptual"] * losses["perceptual_loss"])
    if "envelope_loss" in losses:
        total = total + r.w["envelope"] * losses["envelope_loss"]
    total = (total + adv_w * losses["generator_loss"]
             + fm_w * losses["feature_matching_loss"])
    losses["total_loss"] = total
    g_grads = clipped(dict(zip(g, torch.autograd.grad(total, list(
        g.values())))), r.clip)
    g_new, g_opt = adamw(st.g, g_grads, st.g_opt, r)
    ema = None
    if st.ema is not None:
        ema = {k: r.ema_decay * e + (1 - r.ema_decay) * g_new[k]
               for k, e in st.ema.items()}
    out = {k: float(v.detach()) for k, v in losses.items()}
    out["discriminator_loss"] = float(d_loss)
    return (State(g_new, d_new, g_opt, d_opt, ema, st.g_updates + 1), out,
            {"g": g_grads, "d": d_grads})
