"""Faults planted in the stage-2 trainer a ``gan_train`` run drives, each
of which the check has to read as ``correct: false``. Each takes the
trainer right after the seed's weights are in it (``Context.inject``),
before its first step, so a CUDA graph captures the fault as it would a
change to the program.

- ``unchanged``: a step that returns its state unchanged (neither net nor
  the EMA is updated);
- ``half_batch``: half of the batch left out, each mean taken over the
  rest;
- ``altered``: an answer altered where it is produced: the generator's
  duration prediction negated;
- ``no_feature_matching``: the feature-matching term dropped (it reads 0
  and adds nothing);
- ``no_ema``: the EMA skipped (its decay 1: the shadow never moves);
- ``no_spectral_norm``: the discriminator's spectral norm skipped;
- ``disc_bias_zeroed``: one discriminator conv's bias dropped from its
  output (the first scale's 1024-channel k = 5 conv, its heaviest).
"""

from __future__ import annotations

import torch


def unchanged(t) -> None:
    t._d_update = lambda grads, d_loss, applies: None
    t._g_update = lambda grads, applies: None


def half_batch(t) -> None:
    real = t._step_fn

    def step_fn(keys, d_applies, g_applies, *tensors):
        return real(keys, d_applies, g_applies,
                    *[x[: (x.shape[0] + 1) // 2] for x in tensors])
    t._step_fn = step_fn


def altered(t) -> None:
    real = t._acoustic_and_segment

    def acoustic_and_segment(*a, **k):
        out, mel, audio = real(*a, **k)
        return dict(out, duration_pred=-out["duration_pred"]), mel, audio
    t._acoustic_and_segment = acoustic_and_segment


def no_feature_matching(t) -> None:
    real = t._g_losses

    def g_losses(*a, **k):
        total, losses = real(*a, **k)
        fm = losses["feature_matching_loss"]
        w = t.weights["feature_matching_weight"] * (
            t._ramp if t.adv_warmup > 0 else 1.0)
        losses["feature_matching_loss"] = fm * 0.0
        losses["total_loss"] = total - w * fm
        return losses["total_loss"], losses
    t._g_losses = g_losses


def no_ema(t) -> None:
    t.ema_decay = 1.0


def no_spectral_norm(t) -> None:
    for m in t.discriminator.modules():
        if hasattr(m, "spectral_norm") and hasattr(m, "channels_first"):
            m.spectral_norm = False


def disc_bias_zeroed(t) -> None:
    conv = t.discriminator.scale0.conv5
    real = conv.channels_first

    def channels_first(x: torch.Tensor) -> torch.Tensor:
        b = conv.conv.bias
        return real(x) - b.to(x.dtype)[:, None]
    conv.channels_first = channels_first


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered,
                                  no_feature_matching, no_ema,
                                  no_spectral_norm, disc_bias_zeroed)}
