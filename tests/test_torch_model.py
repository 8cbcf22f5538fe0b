"""M2TTS of the PyTorch port against the flax model: same weights (through
the bridge), same numpy inputs, every output key of ``__call__``,
``acoustic`` and ``synthesize``. Floats at atol 3e-5 / rtol 1e-4 (f32);
integer outputs and masks exactly."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import M2TTS as JaxM2TTS
from m2tts_tpu_torch.models.tts_model import M2TTS, Vocoder, init_params
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(scope="module",
                params=[((4, 4, 2, 2), "layer"), ((8, 8, 2, 2), "layer"),
                        ((4, 4, 2, 2), "batch")],
                ids=["64x", "256x", "64x-batchnorm"])
def pair(request):
    rates, norm = request.param
    kw = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
              text_encoder_layers=2, decoder_layers=2, upsample_rates=rates,
              duration_norm=norm)
    jm = JaxM2TTS(**kw)
    params = jax.device_get(jax.jit(partial(jm.init, max_frames=16,
                                            run_vocoder=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.array([8], jnp.int32)))
    if norm == "batch":  # non-identity folded BatchNorm stats
        rng = np.random.default_rng(3)
        for blk in ("block1", "block2"):
            p = params["params"]["duration_predictor"]["predictor"][blk]
            p["bn_mean"] = rng.normal(scale=0.1, size=p["bn_mean"].shape).astype(np.float32)
            p["bn_var"] = rng.uniform(0.5, 2.0, size=p["bn_var"].shape).astype(np.float32)
    tm = M2TTS(**kw).eval()
    tm.load_state_dict(from_flax(params), strict=True)
    return jm, params, tm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 40, size=(3, 12)).astype(np.int32)
    lengths = np.array([12, 7, 0], np.int32)  # includes a length-0 pad row
    return ids, lengths


def _compare(ref: dict, out: dict, keys):
    for k in keys:
        r = ref[k]
        o = out[k]
        if r is None:
            assert o is None, k
            continue
        r, o = np.asarray(r), o.numpy()
        assert r.shape == o.shape, k
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, err_msg=k, **TOL)


def test_call_with_vocoder(pair):
    jm, params, tm = pair
    ids, lengths = _inputs()
    ref = jm.apply(params, ids, lengths, max_frames=24, run_vocoder=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids), torch.from_numpy(lengths),
                 max_frames=24, run_vocoder=True)
    assert set(out) == set(ref)
    _compare(ref, out, ref.keys())


def test_call_with_target_durations(pair):
    jm, params, tm = pair
    ids, lengths = _inputs(1)
    dur = np.random.default_rng(2).integers(0, 4, size=ids.shape).astype(np.float32)
    ref = jm.apply(params, ids, lengths, target_durations=dur, max_frames=30)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids), torch.from_numpy(lengths),
                 target_durations=torch.from_numpy(dur), max_frames=30)
    _compare(ref, out, ref.keys())


@pytest.mark.parametrize("scale", [1.0, 6.5])
def test_acoustic_and_synthesize(pair, scale):
    jm, params, tm = pair
    ids, lengths = _inputs()
    t_ids, t_len = torch.from_numpy(ids), torch.from_numpy(lengths)
    ref_a = jm.apply(params, ids, lengths, duration_scale=scale,
                     max_frames=40, method=jm.acoustic)
    ref_s = jm.apply(params, ids, lengths, duration_scale=scale,
                     max_frames=40, method=jm.synthesize)
    with torch.no_grad():
        out_a = tm.acoustic(t_ids, t_len, duration_scale=scale, max_frames=40)
        out_s = tm.synthesize(t_ids, t_len, duration_scale=scale,
                              max_frames=40)
    assert set(out_a) == set(ref_a) and set(out_s) == set(ref_s)
    _compare(ref_a, out_a, ref_a.keys())
    _compare(ref_s, out_s, ref_s.keys())
    if scale > 1:
        assert out_s["total_frames"][:2].min() > 0


def test_vocoder_rejects_odd_rate():
    with pytest.raises(ValueError):
        Vocoder(16, 32, 3, (4, 3))


def test_init_params_statistics():
    """The init table: the random-init model's durations sit where the JAX
    model's do (softplus of a near-zero-mean predictor), and the weights
    follow the stated laws."""
    tm = init_params(M2TTS(hidden_dim=64, mel_channels=16, vocoder_channels=32,
                           text_encoder_layers=1, decoder_layers=1),
                     torch.Generator().manual_seed(0), device="cpu")
    assert not tm.training
    emb = tm.text_encoder.embedding.weight
    assert abs(emb.std().item() - 1.0) < 0.05
    conv = tm.vocoder.input_conv.conv.weight  # kaiming normal, fan_in = 16*3
    assert abs(conv.std().item() - (2.0 / 48) ** 0.5) < 0.02
    assert tm.vocoder.input_conv.conv.bias.abs().max() == 0
    up = tm.vocoder.upsample0.weight  # lecun normal truncated at ±2σ
    bound = 2 * (1.0 / (32 * 16)) ** 0.5 / 0.87962566103423978
    assert up.abs().max() <= bound + 1e-6
    ids = torch.zeros((1, 10), dtype=torch.int32)
    with torch.no_grad():
        d = tm(ids, torch.tensor([10]))["duration_pred"]
    assert 0.05 < d.mean().item() < 3.0


def test_init_params_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        init_params(M2TTS(hidden_dim=16, mel_channels=8, vocoder_channels=16,
                          text_encoder_layers=1, decoder_layers=1),
                    torch.Generator().manual_seed(0))
