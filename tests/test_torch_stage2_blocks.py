"""Stage-2 building blocks of the PyTorch port against the JAX package, on
seeded numpy inputs:

- ``ops/stft.py`` (framing, complex STFT, log-mel) against
  ``m2tts_tpu.ops.stft``, a pad longer than the signal included: framing
  exact, the rest within 1e-5 of the largest magnitude;
- every stage-2 loss of ``training/losses.py``, its value (rtol 1e-5) and its
  gradient with respect to ``pred`` against ``jax.grad`` (relative L2 error
  1e-5), the MR-STFT loss at phase weights 0.1 and 0;
- ``spectral_normalize`` (rtol 1e-5) and the ``MultiScaleDiscriminator``
  against flax on weights carried by ``from_flax``, with and without
  spectral norm, at a length that 4 does not divide: logits, all 18 feature
  maps and the gradient with respect to the input, within 1e-5 relative to
  each tensor's largest value;
- the evaluation metrics and ``compute_stoi`` against
  ``m2tts_tpu.evaluation`` (rtol 1e-6 on the host NumPy metrics; 1e-4 on
  the two model benchmarks, whose forward runs in f32 on each framework).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
from m2tts_tpu.data.dataset import make_batches as jax_make_batches
from m2tts_tpu.evaluation import metrics as jmetrics
from m2tts_tpu.evaluation.stoi import compute_stoi as jax_stoi
from m2tts_tpu.models import build_model as jax_build_model
from m2tts_tpu.models import init_params as jax_init_params
from m2tts_tpu.models.components import spectral_normalize as jax_sn
from m2tts_tpu.models.discriminator import \
    MultiScaleDiscriminator as JaxMSD
from m2tts_tpu.ops import stft as jstft
from m2tts_tpu.training import losses as jlosses
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.evaluation import metrics as tmetrics
from m2tts_tpu_torch.evaluation.stoi import compute_stoi
from m2tts_tpu_torch.models.components import spectral_normalize
from m2tts_tpu_torch.models.discriminator import MultiScaleDiscriminator
from m2tts_tpu_torch.models.tts_model import build_model
from m2tts_tpu_torch.ops import stft as tstft
from m2tts_tpu_torch.training import losses as tlosses
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

F32_REL = 1e-5


def _close_rel(got, want, rel=F32_REL, what=""):
    """max |got - want| within rel · max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _audio(rng, shape):
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


# -- STFT ------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,length", [(512, 128, 2048),
                                              (1024, 256, 1531),
                                              (2048, 512, 700)],
                         ids=["512", "1024_odd", "2048_pad_past_end"])
def test_stft_matches_jax(n_fft, hop, length):
    x = _audio(np.random.default_rng(n_fft), (3, length))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(tstft.frame(xt, n_fft, hop).numpy(),
                                  np.asarray(jstft.frame(xj, n_fft, hop)))
    got = tstft.stft(xt, n_fft, hop).numpy()
    want = np.asarray(jstft.stft(xj, n_fft, hop))
    _close_rel(got, want, what="stft")
    _close_rel(tstft.stft_magnitude(xt, n_fft, hop, win_length=n_fft // 2)
               .numpy(), np.asarray(jstft.stft_magnitude(
                   xj, n_fft, hop, win_length=n_fft // 2)), what="win")


def test_log_mel_features_match_jax():
    x = _audio(np.random.default_rng(1), (2, 4096))
    got = tstft.log_mel_features(torch.from_numpy(x), 22050, n_mels=80)
    want = jstft.log_mel_features(jnp.asarray(x), 22050, n_mels=80)
    _close_rel(got.numpy(), np.asarray(want))


# -- losses ----------------------------------------------------------------

def _loss_pair(name, **kw):
    def jfn(p, t):
        return getattr(jlosses, name)(p, t, **kw)

    def tfn(p, t):
        return getattr(tlosses, name)(p, t, **kw)

    return jfn, tfn


@pytest.mark.parametrize("name,kw", [
    ("multi_resolution_stft_loss", {"phase_weight": 0.1}),
    ("multi_resolution_stft_loss", {"phase_weight": 0.0}),
    ("perceptual_loss", {"sample_rate": 22050, "n_mels": 8}),
    ("envelope_correlation_loss", {"sample_rate": 22050}),
], ids=["mrstft_phase0.1", "mrstft_phase0", "perceptual", "envelope"])
def test_waveform_losses_and_grads_match_jax(name, kw):
    rng = np.random.default_rng(7)
    pred, target = _audio(rng, (2, 8192)), _audio(rng, (2, 8192))
    target[1, 4000:7000] = 0.0  # a silent stretch: the envelope's eps case
    # The frames centred on the first and the last sample are symmetric
    # (reflect padding, a symmetric window), so their spectra are real up
    # to rounding and their angle is +pi or -pi by the sign of a rounding
    # error, which differs between FFT libraries. Where pred and target
    # share those samples the two angles are equal within each library.
    # There |pred - target| terms are 0, where the libraries' subgradients
    # of abs differ (JAX 1, torch 0): only samples past the shared ones are
    # held on the gradient.
    E = 1024
    pred[:, :E], pred[:, -E:] = target[:, :E], target[:, -E:]
    jfn, tfn = _loss_pair(name, **kw)
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                          jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tfn(p, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_REL)
    assert _rel_l2(p.grad.numpy()[:, E:-E], np.asarray(jgrad)[:, E:-E]) \
        < F32_REL


def _logits_and_feats(rng, B=2):
    lengths = (50, 25, 13)
    logits = [rng.standard_normal((B, n, 1)).astype(np.float32)
              for n in lengths]
    feats = [[rng.standard_normal((B, n, c)).astype(np.float32)
              for c in (4, 8, 3, 5, 2, 6)] for n in lengths]
    return logits, feats


def test_adversarial_losses_and_grads_match_jax():
    rng = np.random.default_rng(3)
    real_l, real_f = _logits_and_feats(rng)
    fake_l, fake_f = _logits_and_feats(rng)

    def jd(fl):
        return jlosses.lsgan_discriminator_loss(
            [jnp.asarray(a) for a in real_l], fl)

    def jg(fl, ff):
        return (jlosses.lsgan_generator_loss(fl),
                jlosses.feature_matching_loss(
                    [[jnp.asarray(a) for a in fs] for fs in real_f], ff))

    jfl = [jnp.asarray(a) for a in fake_l]
    jff = [[jnp.asarray(a) for a in fs] for fs in fake_f]
    tfl = [torch.from_numpy(a).requires_grad_(True) for a in fake_l]
    tff = [[torch.from_numpy(a).requires_grad_(True) for a in fs]
           for fs in fake_f]
    d_want, d_jgrad = jax.value_and_grad(jd)(jfl)
    d_got = tlosses.lsgan_discriminator_loss(
        [torch.from_numpy(a) for a in real_l], tfl)
    np.testing.assert_allclose(d_got.item(), float(d_want), rtol=F32_REL)
    for g, jgr in zip(torch.autograd.grad(d_got, tfl), d_jgrad):
        assert _rel_l2(g.numpy(), jgr) < F32_REL
    (g_want, fm_want) = jg(jfl, jff)
    g_got = tlosses.lsgan_generator_loss(tfl)
    fm_got = tlosses.feature_matching_loss(
        [[torch.from_numpy(a) for a in fs] for fs in real_f], tff)
    np.testing.assert_allclose(g_got.item(), float(g_want), rtol=F32_REL)
    np.testing.assert_allclose(fm_got.item(), float(fm_want), rtol=F32_REL)
    jgrads = jax.grad(lambda fl, ff: sum(jg(fl, ff)), argnums=(0, 1))(jfl,
                                                                      jff)
    tgrads = torch.autograd.grad(g_got + fm_got,
                                 tfl + [f for fs in tff for f in fs])
    flat_j = list(jgrads[0]) + [f for fs in jgrads[1] for f in fs]
    for g, jgr in zip(tgrads, flat_j):
        assert _rel_l2(g.numpy(), jgr) < F32_REL


@pytest.mark.parametrize("with_adv", [True, False])
def test_combined_generator_loss_matches_jax(with_adv):
    rng = np.random.default_rng(11)
    keys = ["mel_loss", "duration_loss", "spectral_loss", "perceptual_loss",
            "envelope_loss"] + (["generator_loss", "feature_matching_loss"]
                                if with_adv else [])
    vals = {k: float(v) for k, v in zip(keys, rng.uniform(0.1, 3, len(keys)))}
    w = dict(mel_weight=1.0, duration_weight=0.1, adversarial_weight=0.05,
             feature_matching_weight=0.5, spectral_weight=1.0,
             perceptual_weight=0.5, envelope_weight=4.0)
    want = jlosses.combined_generator_loss(
        {k: jnp.float32(v) for k, v in vals.items()}, **w)
    got = tlosses.combined_generator_loss(
        {k: torch.tensor(v) for k, v in vals.items()}, **w)
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_REL)


# -- spectral norm and the discriminator -----------------------------------

@pytest.mark.parametrize("shape", [(41, 4, 128), (3, 1024, 1), (15, 1, 64)])
def test_spectral_normalize_matches_jax(shape):
    w = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_sn(jnp.asarray(w)))
    got = spectral_normalize(torch.from_numpy(w.transpose(2, 1, 0).copy()))
    np.testing.assert_allclose(got.numpy().transpose(2, 1, 0), want,
                               rtol=F32_REL, atol=1e-7)


@pytest.mark.parametrize("sn", [False, True], ids=["plain", "spectral_norm"])
def test_discriminator_matches_flax(sn):
    T = 1030  # 4 divides neither T nor T/2
    x = _audio(np.random.default_rng(9), (2, T))
    jd = JaxMSD(spectral_norm=sn)
    params = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, T, 1)))["params"]
    td = MultiScaleDiscriminator(spectral_norm=sn)
    td.load_state_dict(from_flax(jax.device_get(params)))

    def jscalar(a):
        logits, feats = jd.apply({"params": params}, a)
        return (sum(jnp.sum(l ** 2) for l in logits)
                + sum(jnp.mean(jnp.abs(f)) for fs in feats for f in fs))

    jl, jf = jd.apply({"params": params}, jnp.asarray(x)[..., None])
    jgrad = jax.grad(jscalar)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl, tf = td(xt)  # [B, T] input; flax took [B, T, 1]
    assert len(tl) == 3 and [len(fs) for fs in tf] == [6, 6, 6]
    for a, b in zip(tl, jl):
        _close_rel(a.detach().numpy(), b, what="logits")
    for fs, jfs in zip(tf, jf):
        for a, b in zip(fs, jfs):
            _close_rel(a.detach().numpy(), b, what="feature")
    scalar = (sum((l ** 2).sum() for l in tl)
              + sum(f.abs().mean() for fs in tf for f in fs))
    scalar.backward()
    _close_rel(xt.grad.numpy(), jgrad, what="input grad")


# -- evaluation ------------------------------------------------------------

def test_host_metrics_match_jax():
    rng = np.random.default_rng(2)
    pm, tm = rng.standard_normal((2, 40, 8)), rng.standard_normal((2, 40, 8))
    pa, ta = _audio(rng, (2, 6000)), _audio(rng, (2, 6000))
    pdur, tdur = rng.uniform(0, 4, (2, 12)), rng.uniform(0, 4, (2, 12))
    for name in ("compute_mel_distance", "compute_duration_accuracy"):
        want = getattr(jmetrics, name)(pm[0], tm[0]) if "mel" in name \
            else getattr(jmetrics, name)(pdur, tdur)
        got = getattr(tmetrics, name)(pm[0], tm[0]) if "mel" in name \
            else getattr(tmetrics, name)(pdur, tdur)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    np.testing.assert_allclose(tmetrics.compute_mcd(pm[0].T, tm[0].T),
                               jmetrics.compute_mcd(pm[0].T, tm[0].T),
                               rtol=1e-6)
    ev_t, ev_j = tmetrics.TTSEvaluator(), jmetrics.TTSEvaluator()
    args = (pm, tm, pa, ta, pdur, tdur, np.array([40, 17]))
    want = ev_j.evaluate_batch(*args, n_valid=2)
    got = ev_t.evaluate_batch(*args, n_valid=2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert ev_t.generate_evaluation_report(got) \
        == ev_j.generate_evaluation_report(got)
    mixed = [{"a": 1.0}, {"b": 2.0, "a": 3.0}, {}]
    assert tmetrics.aggregate_metrics(mixed) \
        == jmetrics.aggregate_metrics(mixed) == {"a": 2.0, "b": 2.0}


@pytest.mark.parametrize("sr,n", [(22050, 30000), (16000, 900)],
                         ids=["22k", "too_short"])
def test_stoi_matches_jax(sr, n):
    rng = np.random.default_rng(4)
    clean = _audio(rng, (n,))
    noisy = clean + 0.5 * _audio(rng, (n,))
    want, got = jax_stoi(clean, noisy, sr), compute_stoi(clean, noisy, sr)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(compute_stoi(clean, clean, sr) if n > 2000
                               else 1.0, 1.0, rtol=1e-9)


def test_model_benchmarks_match_jax():
    cfg = {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                            "num_layers": 1, "num_heads": 2},
           "decoder": {"mel_channels": 8, "num_layers": 1},
           "vocoder": {"hidden_channels": 32}}
    jmodel = jax_build_model(JaxConfig(cfg))
    jvars = jax_init_params(jmodel, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32), max_frames=16,
                            run_vocoder=True)
    tmodel = build_model(cfg)  # the port's build_model takes a dict
    tmodel.load_state_dict(from_flax(jax.device_get(jvars["params"])))
    tmodel.train()  # the benchmarks switch to eval mode and back
    params = {k: v.detach() for k, v in tmodel.state_dict().items()}
    ds = JaxDummyDataset(size=24, mel_dim=8, max_text_length=40,
                         max_mel_length=120, seed=0, keep_audio=True)

    def batches(audio):
        return jax_make_batches(ds, 8, [(48, 128)], seed=0, shuffle=False,
                                drop_last=False,
                                audio_samples=128 * 256 if audio else None)

    for name, kw in (("benchmark_model_performance", {"num_samples": 16}),
                     ("benchmark_audio_quality", {"num_samples": 5})):
        want = getattr(jmetrics, name)(jmodel, jvars, batches(True), **kw)
        cache: dict = {}
        got = getattr(tmetrics, name)(tmodel, params, batches(True),
                                      _fn_cache=cache, **kw)
        assert list(got) == list(want) and cache and tmodel.training
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} {k}")
    assert "stoi" in got
