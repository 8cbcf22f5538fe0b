"""The yardstick's arithmetic: the card's peaks, the work a vocoder launch
needs, its roofline bound, and the model's FLOPs an utterance needs.

``stage_work``, ``vocoder_work``, ``bound`` and the peaks are frozen
copies of the chip smoke test's arithmetic, so a later change to the
program cannot move the yardstick. Peaks are NVIDIA's for one H100 SXM,
dense: 989 TFLOP/s in bf16; for float32 the rate of 3×TF32 (495/3
TFLOP/s), the cheapest float32-accurate arithmetic on the card; 3.35 TB/s
of HBM.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 495e12 / 3, "bf16": 989e12}


def stage_work(B: int, T: int, c_mel: int, channels: int, rates, i: int,
               abytes: int):
    """(FLOPs stage ``i``'s launch needs with the zero tconv taps skipped,
    bytes it must move: its input read once, its output written once, its
    weights read once). Activations between stages take ``abytes`` bytes,
    mel in and audio out 4."""
    t, c = T * math.prod(rates[:i]), channels >> i
    r, co = rates[i], c // 2
    first, last = i == 0, i == len(rates) - 1
    flops = 2 * 2 * c * co * r * t + 2 * (2 * 3 * co * co) * r * t
    wcount = 3 * c * r * co + 2 * 3 * co * co
    nbytes = B * t * (c_mel * 4 if first else c * abytes)
    nbytes += B * t * r * (4 if last else co * abytes)
    if first:
        flops += 2 * 3 * c_mel * c * t
        wcount += 3 * c_mel * c
    if last:
        flops += 2 * 3 * co * t * r
        wcount += 3 * co
    return B * flops, nbytes + wcount * abytes


def vocoder_work(B: int, T: int, c_mel: int, channels: int, rates,
                 wbytes: int):
    """(FLOPs this input needs with the zero tconv taps skipped, bytes that
    must move: mel read, audio written, weights read once)."""
    flops = sum(stage_work(B, T, c_mel, channels, rates, i, wbytes)[0]
                for i in range(len(rates)))
    wcount = 3 * c_mel * channels + 3 * (channels >> len(rates))
    c = channels
    for r in rates:
        wcount += 3 * c * r * (c // 2) + 2 * 3 * (c // 2) ** 2
        c //= 2
    return flops, (B * T * c_mel * 4 + B * T * math.prod(rates) * 4
                   + wcount * wbytes)


def bound(flops: int, nbytes: int, cd: str):
    """(least ms the card could take, what bounds it)."""
    ops_ms = flops / PEAK_FLOPS[cd] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def launch_bound_ms(B: int, T: int, c_mel: int, channels: int,
                    rates: Sequence[int], cd: str) -> float:
    """The least time of one vocoder forward on [B, T] mel: the sum over
    its stage launches (one launch a stage) of each launch's bound."""
    abytes = 2 if cd == "bf16" else 4
    return sum(bound(*stage_work(B, T, c_mel, channels, tuple(rates), i,
                                 abytes), cd)[0]
               for i in range(len(rates)))


class ModelFlops:
    """FLOPs of one utterance through the reference model, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them on meta
    tensors: the encoder and duration predictor at S phonemes, the
    decoder and vocoder at F frames. Each part's count is a polynomial of
    degree 2 in its length (linear layers and convs grow with it, the
    attention's products with its square), so three counts fix it and a
    fourth checks it."""

    def __init__(self, model_cfg: Dict):
        from portbench.reference import model as ref

        self.ref, self.sizes = ref, ref.Sizes(model_cfg)
        spec = ref.param_spec(self.sizes)
        self.sd = {n: torch.empty(shape, device="meta") for n, shape, _ in spec}
        self.enc = self._fit(self._enc_flops, (16, 32, 64), 128)
        self.dec = self._fit(self._dec_flops, (64, 128, 256), 512)

    def _count(self, fn) -> int:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            fn()
        return int(counter.get_total_flops())

    def _enc_flops(self, S: int) -> int:
        ids = torch.zeros((1, S), dtype=torch.long, device="meta")
        lengths = torch.full((1,), S, dtype=torch.long, device="meta")

        def run():
            enc, _ = self.ref.encode(self.sd, self.sizes, ids, lengths)
            self.ref.durations(self.sd, enc)
        return self._count(run)

    def _dec_flops(self, F: int) -> int:
        x = torch.empty((1, F, self.sizes.hidden), device="meta")

        def run():
            self.ref.vocode(self.sd, self.sizes,
                            self.ref.decode(self.sd, self.sizes, x))
        return self._count(run)

    @staticmethod
    def _fit(fn, xs: Tuple[int, int, int], check: int):
        ys = [fn(x) for x in xs]
        coef = [float(c) for c in np.polyfit(xs, ys, 2)]

        def poly(x):
            return coef[0] * x * x + coef[1] * x + coef[2]
        if abs(poly(check) - fn(check)) > 1e-6 * fn(check) + 1:
            raise RuntimeError("the model's FLOPs are not quadratic in length")
        return poly

    def utterance(self, phonemes: int, frames: int) -> float:
        return self.enc(phonemes) + self.dec(frames)


class GanStepFlops:
    """FLOPs of one fused stage-2 GAN step at a bucket's shapes, as
    ``FlopCounterMode`` counts them on meta tensors through the reference
    (``reference/gan.py``), the passes the fused step's algorithm needs and
    no recomputation: the discriminator step's generator forward without
    gradients; the discriminator on ``[real; fake]`` with its backward over
    its weights; the generator step's generator forward; the discriminator
    on the fake with its backward into the generator (its weights
    constants) and on the real forward only; the loss terms' products.
    FFTs and elementwise work (dropout, the optimizers, the EMA) are not
    products and are not counted."""

    def __init__(self, model_cfg: Dict, training: Dict,
                 sample_rate: int = 22050, n_mels: int = 80):
        from portbench.reference import gan
        from portbench.reference import model as ref

        self.gan, self.ref = gan, ref
        self.sizes = ref.Sizes(model_cfg)
        self.B = int(training["batch_size"])
        self.r = gan.Recipe(training, self.sizes.upsample, sample_rate,
                            n_mels)
        self.spectral = bool(training.get("discriminator_spectral_norm"))
        self._counts: Dict[Tuple[int, int], int] = {}

    def step(self, text: int, frames: int) -> int:
        key = (int(text), int(frames))
        if key not in self._counts:
            self._counts[key] = self._count(*key)
        return self._counts[key]

    def _count(self, S: int, T: int) -> int:
        from torch.utils.flop_counter import FlopCounterMode

        gan, s, r, B = self.gan, self.sizes, self.r, self.B
        meta = {"device": "meta"}

        def params(spec, grad):
            return {n: torch.empty(shape, **meta).requires_grad_(grad)
                    for n, shape, _ in spec}
        g = params(self.ref.param_spec(s), True)
        d = params(gan.disc_param_spec(), True)
        dc = {k: v.detach() for k, v in d.items()}
        batch = {"phoneme_ids": torch.zeros((B, S), dtype=torch.long, **meta),
                 "text_lengths": torch.full((B,), S, dtype=torch.long,
                                            **meta),
                 "durations": torch.zeros((B, S), **meta),
                 "mel": torch.empty((B, T, s.mel), **meta),
                 "mel_lengths": torch.full((B,), T, dtype=torch.long, **meta)}
        offsets = torch.zeros((B,), dtype=torch.int32, **meta)
        target = torch.empty((B, r.seg_frames * r.upsample), **meta)

        def nodrop(x):
            return x
        with FlopCounterMode(display=False) as counter:
            with torch.no_grad():
                fake = gan.generate(g, s, batch, offsets, r.seg_frames,
                                    nodrop)[2]
            logits, _ = gan.discriminate(d, torch.cat([target, fake]),
                                         spectral=self.spectral)
            loss = gan.lsgan_d([l[:B] for l in logits],
                               [l[B:] for l in logits])
            torch.autograd.grad(loss, list(d.values()))
            mel, dur, audio = gan.generate(g, s, batch, offsets,
                                           r.seg_frames, nodrop)
            total = sum(gan.losses_of(mel, dur, audio, target, batch,
                                      r).values())
            fl, ff = gan.discriminate(dc, audio, spectral=self.spectral)
            with torch.no_grad():
                _, rf = gan.discriminate(dc, target, spectral=self.spectral)
            total = total + gan.lsgan_g(fl) + gan.feature_matching(rf, ff)
            torch.autograd.grad(total, list(g.values()))
        return int(counter.get_total_flops())
