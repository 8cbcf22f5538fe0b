"""The stage-2 GAN step of the PyTorch port (``training/trainer_stage2.py``)
against the JAX package's ``Stage2Trainer`` on the CPU, at a tiny size
(1 layer, 32-d, 8 mel bins, a 32-channel vocoder, 2048-sample segments,
batch 8, dropout 0), the weights carried by ``from_flax`` and the same host
batches fed to both (each trainer draws its segments from
``default_rng(seed + 2)``):

- three fused steps in f32 with spectral norm, the envelope loss, the
  warmup ramp (over 2 updates), both adaptive guards (floor 2, so the
  guards sit near 0.5) and EMA 0.5: every logged loss and ``adv_guard``
  within 1e-5 relative; after the first step the discriminator's weights
  (the guard-scaled update) and its Adam moments, after two the EMA, after
  three both nets' weights, within lr/10 (lr 1e-3);
- three fused steps in bf16 at lr 1e-4: losses within 1e-2 relative,
  weights within 10·lr (a near-zero bf16 gradient may flip the sign of an
  Adam update);
- ``alternate_gd`` (D on even steps, G on odd, no ``adv_guard`` on a G
  step) against JAX's ``_d_step``/``_g_step``, and accumulation over k = 2
  micro-steps, with the same bars;
- ``_segment_audio``'s offsets and targets equal to JAX's for one seed.

The MR-STFT loss runs at phase weight 0 here: its angle term is held in
``test_torch_stage2_blocks.py``; in a step the frames centred on a
segment's ends are real up to rounding, so their angles are ±pi by the
sign of a rounding error that the two FFT libraries do not share.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
from m2tts_tpu.data.dataset import data_iterator as jax_data_iterator
from m2tts_tpu.training import trainer_stage2 as jstage2
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.data.dataset import DummyDataset
from m2tts_tpu_torch.training import trainer_stage2 as tstage2
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax, optimizer_state_from_optax

torch.set_num_threads(2)

DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0, keep_audio=True)
LR = 1e-3
PARAMS_ATOL = LR / 10
LOSS_RTOL = {False: 1e-5, True: 1e-2}


def tiny_config(tmp_path, **training):
    t = {"batch_size": 8, "max_steps": 3, "learning_rate": LR,
         "warmup_steps": 0, "lr_scheduler": "constant",
         "gradient_clip_norm": 1.0, "bf16": False, "audio_segment_len": 512,
         "log_every": 1, "save_every": 100, "validate_every": 100,
         "seed": 0, "stft_phase_weight": 0.0}
    t.update(training)
    return {
        "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                                   "num_layers": 1, "num_heads": 2,
                                   "dropout": 0.0},
                  "decoder": {"mel_channels": 8, "num_layers": 1},
                  "vocoder": {"hidden_channels": 32}},
        "training": t,
        "data": {"buckets": [[48, 128]], "n_mels": 8, "hop_length": 256},
        "system": {"mesh": {"data": -1}, "log_metrics": "jsonl"},
        "paths": {"output_dir": str(tmp_path / "out"),
                  "checkpoint_dir": str(tmp_path / "out/ckpt"),
                  "log_dir": str(tmp_path / "out/logs")},
    }


def _pair(tmp_path, **training):
    """(JAX trainer, port trainer on the JAX weights, host batches)."""
    cfg = tiny_config(tmp_path, **training)
    jt = jstage2.Stage2Trainer(JaxConfig(cfg),
                               dataset=JaxDummyDataset(**DS_KW))
    pt = tstage2.Stage2Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                               device="cpu")
    pt.model.load_state_dict(from_flax(jax.device_get(jt.g_state.params)))
    pt.discriminator.load_state_dict(
        from_flax(jax.device_get(jt.d_state.params)))
    if pt.ema is not None:
        with torch.no_grad():
            for e, p in zip(pt.ema, pt.g_params):
                e.copy_(p)
    batches = list(itertools.islice(jax_data_iterator(
        JaxDummyDataset(**DS_KW), 8, jt.buckets, seed=0,
        audio_samples=jt._max_audio_samples()), 3))
    return jt, pt, batches


def _max_abs(module_sd, flax_tree):
    ref = from_flax(jax.device_get(flax_tree))
    assert set(ref) == set(module_sd)
    return max(float((module_sd[k] - ref[k]).abs().max()) for k in ref)


def _params_err(pt, jt):
    return {"generator": _max_abs(pt.model.state_dict(), jt.g_state.params),
            "discriminator": _max_abs(pt.discriminator.state_dict(),
                                      jt.d_state.params)}


def _run(jt, pt, batches, check=None):
    """Feed each batch to both trainers; per step the two metric dicts and
    whatever ``check(step)`` measures."""
    out = []
    for i, b in enumerate(batches):
        mj = {k: float(v) for k, v in jt.train_step(b).items()}
        mp = {k: v.item() for k, v in pt.train_step(b).items()}
        out.append({"jax": mj, "port": mp,
                    **(check(i) if check is not None else {})})
    return out


def _assert_losses(steps, rtol):
    for i, st in enumerate(steps):
        assert set(st["port"]) == set(st["jax"]), i
        for k, v in st["jax"].items():
            np.testing.assert_allclose(st["port"][k], v, rtol=rtol,
                                       err_msg=f"step {i} {k}")


# -- f32 and bf16 fused steps ------------------------------------------------

@pytest.fixture(scope="module")
def f32_steps(tmp_path_factory):
    jt, pt, batches = _pair(
        tmp_path_factory.mktemp("f32"), discriminator_spectral_norm=True,
        envelope_loss_weight=4.0, adversarial_warmup_steps=2,
        adaptive_adv_dloss_floor=2.0, adaptive_d_lr_floor=2.0,
        ema_decay=0.5)

    def check(i):
        if i == 0:  # the guard-scaled D update and its Adam moments
            want = optimizer_state_from_optax(
                jax.device_get(jt.d_state.opt_state), pt.discriminator)
            got = pt.d_opt.state_dict()
            moments = max(float((got[m][n] - want[m][n]).abs().max())
                          for m in ("mu", "nu") for n in got["mu"])
            return {"params": _params_err(pt, jt), "d_moments": moments,
                    "d_count": (got["count"], want["count"])}
        if i == 1:
            return {"ema": _max_abs(dict(zip(pt.g_names, pt.ema)),
                                    jt.ema_params)}
        return {"params": _params_err(pt, jt)}

    steps = _run(jt, pt, batches, check)
    jt.close()
    pt.close()
    return steps


def test_fused_f32_step_matches_jax(f32_steps):
    first = f32_steps[0]
    assert {"discriminator_loss", "total_loss", "generator_loss",
            "feature_matching_loss", "envelope_loss",
            "adv_guard"} <= set(first["port"])
    _assert_losses(f32_steps[:1], LOSS_RTOL[False])
    assert max(first["params"].values()) < PARAMS_ATOL, first["params"]


def test_three_f32_steps_match_jax(f32_steps):
    _assert_losses(f32_steps, LOSS_RTOL[False])
    assert max(f32_steps[2]["params"].values()) < PARAMS_ATOL


def test_guards_and_ramp_match_jax(f32_steps):
    """The D guard scaled the update while Adam's moments advanced as
    without it; the G guard equals JAX's and sits inside (0, 1); the total
    applies the ramp (0, 0.5, 1 over the three steps) and the guard to the
    adversarial weight, the ramp alone to feature matching."""
    first = f32_steps[0]
    assert first["d_count"] == (1, 1)
    assert first["d_moments"] < 1e-6
    for i, st in enumerate(f32_steps):
        m = st["port"]
        assert 0.0 < m["adv_guard"] < 1.0
        ramp = min(i / 2, 1.0)
        expect = (m["mel_loss"] + 0.1 * m["duration_loss"]
                  + m["spectral_loss"] + 0.5 * m["perceptual_loss"]
                  + 4.0 * m["envelope_loss"]
                  + 0.25 * ramp * m["adv_guard"] * m["generator_loss"]
                  + 2.0 * ramp * m["feature_matching_loss"])
        np.testing.assert_allclose(m["total_loss"], expect, rtol=1e-6)


def test_ema_after_two_steps_matches_jax(f32_steps):
    assert f32_steps[1]["ema"] < PARAMS_ATOL


def test_fused_bf16_steps_match_jax(tmp_path):
    """At lr 1e-4. An Adam update moves a weight by up to ~lr·sign(g), and
    a bf16 gradient near 0 can take the other sign in either framework, so
    after three updates a weight may be several lr away: the weights are
    held to 10·lr, the bf16 bar of tests/test_torch_train.py. oneDNN's
    bf16 CPU convolutions (not used on the card, which runs cuDNN) give
    NaN in the discriminator at these weights after one update, so this
    case runs torch's own CPU convolutions."""
    lr = 1e-4
    jt, pt, batches = _pair(tmp_path, bf16=True, learning_rate=lr)
    with torch.backends.mkldnn.flags(enabled=False):
        steps = _run(jt, pt, batches)
    _assert_losses(steps, LOSS_RTOL[True])
    err = _params_err(pt, jt)
    assert max(err.values()) < 10 * lr, err


# -- alternation and accumulation -------------------------------------------

def test_alternate_gd_matches_jax(tmp_path):
    jt, pt, batches = _pair(tmp_path, alternate_gd=True,
                            adaptive_adv_dloss_floor=2.0)
    steps = _run(jt, pt, batches[:2], lambda i: {"params": _params_err(pt,
                                                                      jt)})
    assert set(steps[0]["port"]) == {"discriminator_loss"}
    assert "discriminator_loss" not in steps[1]["port"]
    assert "adv_guard" not in steps[1]["port"]  # no d_loss of its batch
    assert (pt.d_updates, pt.g_updates) == (1, 1)
    _assert_losses(steps, LOSS_RTOL[False])
    for st in steps:
        assert max(st["params"].values()) < PARAMS_ATOL, st["params"]


def test_accumulation_k2_matches_jax(tmp_path):
    jt, pt, batches = _pair(tmp_path, gradient_accumulation_steps=2)
    g0 = {k: v.clone() for k, v in pt.model.state_dict().items()}
    steps = _run(jt, pt, batches[:2], lambda i: {
        "params": _params_err(pt, jt),
        "moved": max(float((v - g0[k]).abs().max())
                     for k, v in pt.model.state_dict().items()),
        "counts": (pt.g_opt.count, pt.g_opt.mini_step)})
    assert steps[0]["moved"] == 0.0 and steps[0]["counts"] == (0, 1)
    assert steps[1]["moved"] > 0.0 and steps[1]["counts"] == (1, 0)
    _assert_losses(steps, LOSS_RTOL[False])
    for st in steps:
        assert max(st["params"].values()) < PARAMS_ATOL, st["params"]


# -- host segments -----------------------------------------------------------

@pytest.mark.parametrize("upsample", [256, 64], ids=["same_rate",
                                                     "resampled"])
def test_segment_audio_matches_jax(upsample):
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((5, 100 * 256)).astype(np.float32)
    mel_lengths = np.array([100, 50, 8, 3, 77])
    args = (audio, mel_lengths, 8, 256, upsample)
    off_t, tgt_t = tstage2._segment_audio(*args, np.random.default_rng(42))
    off_j, tgt_j = jstage2._segment_audio(*args, np.random.default_rng(42))
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(tgt_t, tgt_j)
    assert off_t[3] == 0 and (off_t <= np.maximum(mel_lengths - 8, 0)).all()
