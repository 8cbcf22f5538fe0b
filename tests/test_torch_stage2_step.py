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
- two fused f32 steps with ``disc_lowering: packed`` (no spectral norm) on
  both sides, the port's through ``packed_multiscale_apply``, at lr 1e-4
  (the bf16 case's) with the same bars (weights lr/10), and equal to the
  port's native lowering at those bars, for two weight seeds;
- the same recipe at lr 1e-3 for two seeds, both lowerings in both
  frameworks and the port in f64: the first step held at the same bars,
  and the ill-conditioning that parts any two runs after it shown;
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


def _f64_twin(tmp_path, pt, **training):
    """A port trainer on ``pt``'s weights with both nets in f64."""
    t = tstage2.Stage2Trainer(Config(tiny_config(tmp_path, **training)),
                              dataset=DummyDataset(**DS_KW), device="cpu")
    t.model.load_state_dict(pt.model.state_dict())
    t.discriminator.load_state_dict(pt.discriminator.state_dict())
    t.model.double()
    t.discriminator.double()
    return t


def _f64_batch(t, batch):
    """``batch`` prepared by ``t`` (its own segment stream) in f64."""
    return {k: v.astype(np.float64) if getattr(v, "dtype", None)
            == np.float32 else v for k, v in t._prepare(batch).items()}


def test_packed_disc_lowering_steps_match_jax(tmp_path, monkeypatch):
    """At lr 1e-4: at the file's lr 1e-3 without spectral norm the steps
    after the first are ill-conditioned, in either lowering and either
    framework (``test_lowerings_at_lr_1e3``)."""
    _packed_steps_match_jax(tmp_path, monkeypatch, seed=0)


def test_packed_disc_lowering_steps_match_jax_seed1(tmp_path, monkeypatch):
    """The same on the weights of another seed."""
    _packed_steps_match_jax(tmp_path, monkeypatch, seed=1)


def _packed_steps_match_jax(tmp_path, monkeypatch, seed):
    lr = 1e-4
    kw = dict(disc_lowering="packed", discriminator_spectral_norm=False,
              learning_rate=lr, seed=seed)
    jt, pt, batches = _pair(tmp_path, **kw)
    native = tstage2.Stage2Trainer(
        Config(tiny_config(tmp_path / "native", **dict(
            kw, disc_lowering="native"))),
        dataset=DummyDataset(**DS_KW), device="cpu")
    native.model.load_state_dict(pt.model.state_dict())
    native.discriminator.load_state_dict(pt.discriminator.state_dict())
    assert jt.disc_lowering == pt.disc_lowering == "packed"
    assert native.disc_lowering == "native"
    applies = []
    apply = tstage2.packed_multiscale_apply
    monkeypatch.setattr(tstage2, "packed_multiscale_apply",
                        lambda *a, **k: applies.append(1) or apply(*a, **k))
    steps = _run(jt, pt, batches[:2], lambda i: {
        "params": _params_err(pt, jt),
        "native": {k: v.item() for k, v in native.train_step(
            batches[i]).items()},
        "vs_native": max(float((v - ref.state_dict()[k]).abs().max())
                         for mod, ref in ((pt.model, native.model),
                                          (pt.discriminator,
                                           native.discriminator))
                         for k, v in mod.state_dict().items())})
    # a fused step applies the discriminator three times (D on [real;
    # fake], G's fake, G's real); the native trainer never
    assert len(applies) == 6
    _assert_losses(steps, LOSS_RTOL[False])
    _assert_losses([{"jax": st["native"], "port": st["port"]}
                    for st in steps], LOSS_RTOL[False])
    for st in steps:
        assert max(st["params"].values()) < lr / 10, st["params"]
        assert st["vs_native"] < lr / 10
    for t in (jt, pt, native):
        t.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_lowerings_at_lr_1e3(tmp_path, capsys, seed):
    """The file's lr 1e-3 without spectral norm, for two weight seeds: JAX
    and the port in both lowerings, and the port's native lowering in f64,
    three fused steps on the same batches.

    Held: every loss of the first step, between every two of the five
    runs, within 1e-5 relative, and the discriminator's weights after its
    first update within lr/10 of the f64 run's.

    Not held, and why: from the second step on, two f32 runs (either
    framework, either lowering, or f32 against f64) may part by more than
    1e-5 in ``generator_loss``, on one seed and not on the other. Two
    things amplify f32 rounding there. Adam's first update moves a weight
    whose clipped gradient is near its eps (1e-8) by an amount that the
    gradient's rounding decides. And the generator's adversarial gradient
    is ill-conditioned in the fake audio it is taken at (LeakyReLU's
    kinks), which is shown here: in f64, against the f64 run's
    discriminator of each step, the gradient of ``generator_loss`` in the
    audio, taken at the port's f32 audio and at the f64 run's, parts at
    some step by more than 10 times the two audios' relative distance (a
    well-conditioned function keeps the two about equal). Which runs part
    is chance: the port's first fake audio is held as close to the f64
    audio as twice JAX's. The readings (per step, the largest relative
    loss gap between two runs; JAX's first audio beside the port's) print
    as one JSON line (``pytest -s``)."""
    import json

    from m2tts_tpu_torch.training import losses as tlosses

    kw = dict(discriminator_spectral_norm=False, seed=seed)
    runs = {}
    for low in ("native", "packed"):
        jt, pt, batches = _pair(tmp_path / low, disc_lowering=low, **kw)
        assert jt.disc_lowering == pt.disc_lowering == low
        runs[f"jax_{low}"], runs[f"port_{low}"] = jt, pt
    f64 = _f64_twin(tmp_path / "f64", runs["port_native"],
                    disc_lowering="native", **kw)
    audio = {"f32": [], "f64": []}  # each forward's fake audio, two a step
    for name, t in (("f32", runs["port_native"]), ("f64", f64)):
        def fake(*a, _fn=t._acoustic_and_segment, _name=name, **k):
            out = _fn(*a, **k)
            audio[_name].append(out[2].detach().double().clone())
            return out

        t._acoustic_and_segment = fake
    losses = {name: [] for name in (*runs, "port_f64")}
    # a host copy: the JAX step donates its state's buffers
    d64, g0 = [], jax.device_get(runs["jax_native"].g_state.params)
    for i, b in enumerate(batches):
        for name, t in runs.items():
            losses[name].append({k: float(v)
                                 for k, v in t.train_step(b).items()})
        h64 = _f64_batch(f64, b)
        if i == 0:
            first = dict(h64)
        losses["port_f64"].append({k: float(v) for k, v in f64.train_step(
            h64).items()})
        # the discriminator the step's generator update was taken against
        d64.append({k: v.detach().clone() for k, v in
                    f64.discriminator.state_dict().items()})
        if i == 0:
            d_err = {name: _max_abs(d64[0], t.d_state.params)
                     if name.startswith("jax") else max(
                         float((v.double() - d64[0][k]).abs().max())
                         for k, v in t.discriminator.state_dict().items())
                     for name, t in runs.items()}

    def gap(a, b, i):
        return max(abs(losses[a][i][k] - v) / max(abs(v), 1e-30)
                   for k, v in losses[b][i].items())

    pairs = [("port_native", "jax_native"), ("port_packed", "jax_packed"),
             ("port_packed", "port_native"), ("jax_packed", "jax_native"),
             ("jax_native", "port_f64"), ("port_native", "port_f64")]
    readings = {f"{a} vs {b}": [gap(a, b, i) for i in range(len(batches))]
                for a, b in pairs}
    names = list(losses)
    first_step = max(gap(a, b, 0) for a in names for b in names if a != b)

    def loss_grad(d, at):  # in f64
        x = at.clone().requires_grad_(True)
        logits, _ = f64._disc_apply(d, x)
        return torch.autograd.grad(tlosses.lsgan_generator_loss(logits),
                                   x)[0]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    assert len(audio["f32"]) == len(audio["f64"]) == 2 * len(batches)
    audio_rel, grad_rel = [], []
    for i, d in enumerate(d64):
        a32, a64 = audio["f32"][2 * i], audio["f64"][2 * i]
        audio_rel.append(rel(a32, a64))
        grad_rel.append(rel(loss_grad(d, a32), loss_grad(d, a64)))
    gain = max(g / a for g, a in zip(grad_rel, audio_rel))
    # JAX's first fake audio (the same weights, batch and window; dropout
    # 0), against the same f64 audio and discriminator
    jt = runs["jax_native"]
    jax_fake = jax.jit(lambda p, bb: jt._acoustic_and_segment(
        p, bb, jax.random.PRNGKey(0), False)[2])
    a_jax = torch.from_numpy(np.array(jax_fake(g0, {
        k: v.astype(np.float32) if v.dtype == np.float64 else v
        for k, v in first.items()}))).double()
    jax_audio_rel = rel(a_jax, audio["f64"][0])
    jax_grad_rel = rel(loss_grad(d64[0], a_jax),
                       loss_grad(d64[0], audio["f64"][0]))
    with capsys.disabled():
        print(json.dumps({"seed": seed, "first_step_max_rel": first_step,
                          "d_weights_after_first_vs_f64": d_err,
                          "audio_rel_f32_vs_f64": audio_rel,
                          "adv_audio_grad_rel_f64": grad_rel,
                          "max_grad_over_audio": gain,
                          "jax_first_audio_rel_f32_vs_f64": jax_audio_rel,
                          "jax_first_adv_audio_grad_rel_f64": jax_grad_rel,
                          "max_rel_loss_gap_by_step": readings}))
    assert first_step < LOSS_RTOL[False], readings
    assert max(d_err.values()) < LR / 10, d_err
    assert gain > 10, (grad_rel, audio_rel)
    # the port's f32 generator forward is as close to f64 as JAX's
    assert audio_rel[0] < 2 * jax_audio_rel, (audio_rel[0], jax_audio_rel)
    for t in (*runs.values(), f64):
        t.close()


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
