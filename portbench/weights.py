"""Weights from the seed, made on the device in two large draws.

The init rule is the model's own (a frozen copy): xavier-uniform linear
weights, normal conv weights with a fan-in gain of √2, normal transposed-
conv weights truncated at ±2σ with σ = 1/√(in·out)/0.8796 (unit variance
after truncation), N(0, 1) embeddings. One departure: where the rule
starts biases at 0 and LayerNorm gains at 1, they are drawn here about
them, as a trained model's lie, so a kernel that drops or misplaces a bias
or a LayerNorm's affine gives wrong audio. In the acoustic model, whose
LayerNorms keep every activation near unit scale, as N(0, ``AFFINE_STD``)
and 1 + N(0, ``AFFINE_STD``). The vocoder has no norm, and the init rule
shrinks its signal by some 500 times from mel to audio, so a bias of a
fixed size would drown the signal in a constant and leave the audio
nearly the same for every text. Each vocoder bias is drawn instead as
N(0, ``VOCODER_BIAS`` × the RMS of its layer's output), that RMS read
once from the reference with the vocoder's biases at 0, on the decoder's
mel of a unit normal input. One normal and one uniform buffer are drawn
from a generator on the device, and every weight is a scaled view of one
of them, so making 18 M parameters costs two kernel launches and a few
hundred small ones.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import model as ref
from portbench.reference.model import Sizes, param_spec

TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated at ±2
AFFINE_STD = 0.1  # spread of the acoustic model's biases and LN gains
VOCODER_BIAS = 0.1  # a vocoder bias's spread over its layer's output RMS
PROBE_FRAMES = 128  # frames of the input that sets the vocoder's scale


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


@torch.no_grad()
def make_state_dict(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 state dict of the configuration's model from ``seed``."""
    spec = param_spec(Sizes(model))
    n_norm = sum(math.prod(shape) for _, shape, kind in spec
                 if kind in ("conv", "embed", "ones", "zeros"))
    n_unif = sum(math.prod(shape) for _, shape, kind in spec
                 if kind in ("linear", "tconv"))
    g = seed_generator(seed, device)
    normal = torch.randn(n_norm, generator=g, device=device)
    uniform = torch.rand(n_unif, generator=g, device=device)
    lo, hi = (0.5 * (1 + math.erf(-2 / math.sqrt(2))),
              0.5 * (1 + math.erf(2 / math.sqrt(2))))
    sd, i_n, i_u = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind in ("conv", "embed", "ones", "zeros"):
            x = normal[i_n:i_n + n].view(shape)
            i_n += n
            if kind == "conv":
                x = x * math.sqrt(2.0 / (shape[1] * shape[2]))
            elif kind != "embed":
                x = x * AFFINE_STD + (kind == "ones")
        elif kind in ("linear", "tconv"):
            u = uniform[i_u:i_u + n].view(shape)
            i_u += n
            if kind == "linear":
                a = math.sqrt(6.0 / (shape[0] + shape[1]))
                x = (2 * u - 1) * a
            else:
                std = math.sqrt(1.0 / (shape[0] * shape[1])) / TRUNC_STD
                x = torch.special.ndtri(lo + (hi - lo) * u) * std
        else:
            raise ValueError(f"no init rule for {name} ({kind})")
        sd[name] = x.contiguous()
    _scale_vocoder_biases(sd, Sizes(model), g)
    return sd


def _scale_vocoder_biases(sd: Dict[str, torch.Tensor], s: Sizes,
                          g: torch.Generator) -> None:
    """Each vocoder bias, drawn as N(0, ``AFFINE_STD``) above, rescaled to
    N(0, ``VOCODER_BIAS`` × its layer's output RMS) (see the module's
    docstring)."""
    names = [k for k in sd if k.startswith("vocoder.") and
             k.endswith(".bias")]
    dev = sd[names[0]].device
    zeroed = dict(sd, **{k: torch.zeros_like(sd[k]) for k in names})
    x = torch.randn((1, PROBE_FRAMES, s.hidden), generator=g, device=dev)
    taps: Dict[str, float] = {}
    with ref.exact():
        ref.vocode(zeroed, s, ref.decode(sd, s, x), taps=taps)
    for k in names:
        sd[k] = sd[k] * (VOCODER_BIAS * taps[k] / AFFINE_STD)


DISC_TAG = 0x5D15C  # the discriminator's stream of the run's seed
DISC_PROBE = 8192  # samples of the input that sets its biases' scale


@torch.no_grad()
def make_disc_state_dict(seed: int, device, spectral: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """The float32 state dict of the stage-2 multi-scale discriminator from
    ``seed`` (a stream of its own): normal conv weights with a fan-in gain
    of √2 (fan-in: input channels a group times the kernel), as the
    model's init rule, and each bias, which the rule starts at 0, drawn as
    N(0, ``VOCODER_BIAS`` × the RMS of its conv's output), that RMS read
    once from the reference with the biases at 0 on N(0, 0.3²) audio, so a
    dropped or misplaced bias changes the logits."""
    from portbench.reference import gan

    spec = gan.disc_param_spec()
    g = seed_generator((int(seed) + DISC_TAG) % (2 ** 63), device)
    n = sum(math.prod(shape) for _, shape, _ in spec)
    normal = torch.randn(n, generator=g, device=device)
    sd, i = {}, 0
    for name, shape, kind in spec:
        k = math.prod(shape)
        x = normal[i:i + k].view(shape)
        i += k
        if kind == "conv":
            x = x * math.sqrt(2.0 / (shape[1] * shape[2]))
        sd[name] = x.contiguous()
    biases = [k for k in sd if k.endswith(".bias")]
    zeroed = dict(sd, **{k: torch.zeros_like(sd[k]) for k in biases})
    probe = 0.3 * torch.randn((2, DISC_PROBE), generator=g, device=device)
    taps: Dict[str, float] = {}
    with ref.exact():
        gan.discriminate(zeroed, probe, spectral=spectral, taps=taps)
    for k in biases:
        sd[k] = sd[k] * (VOCODER_BIAS * taps[k])
    return sd
