"""Vocoder of the PyTorch port: packed weights, the plain packed-matmul
forward and the ``Vocoder`` module against the JAX packing and both Pallas
kernels (interpret mode), and the CUDA wrapper's CPU behaviour. The cases
that need a card are in ``test_torch_cuda.py``.

Tolerances: f32 atol 3e-5 / rtol 1e-4. bf16 (the port's plain version
against the Pallas kernels, both with bf16 matmul inputs, f32 sums and the
same rounding points): max abs 2e-2 and mean abs 1e-3 — the sums run in
another order, so an intermediate may round to the neighbouring bf16 value
(2^-8 relative) and that propagates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import Vocoder as JaxVocoder
from m2tts_tpu.ops import vocoder_mm as jmm
from m2tts_tpu.ops.pallas.vocoder import fused_vocoder_forward as pallas_padded
from m2tts_tpu.ops.pallas.vocoder_packed import (
    fused_vocoder_packed_forward as pallas_packed)
from m2tts_tpu_torch.models.tts_model import M2TTS, Vocoder
from m2tts_tpu_torch.ops import vocoder_mm as tmm
from m2tts_tpu_torch.ops.cuda import build
from m2tts_tpu_torch.ops.cuda import vocoder as cuda_vocoder
from m2tts_tpu_torch.serving.pipeline import Synthesizer
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

F32 = dict(atol=3e-5, rtol=1e-4)
BF16_MAX, BF16_MEAN = 2e-2, 1e-3


@pytest.fixture(scope="module",
                params=[((4, 4, 2, 2), 64), ((8, 8, 2, 2), 64),
                        ((8, 8, 2, 2), 128)],
                ids=["64x-c64", "256x-c64", "256x-c128"])
def setup(request):
    rates, channels = request.param
    model = JaxVocoder(mel_channels=16, hidden_channels=channels,
                       upsample_rates=rates)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16), jnp.float32)))["params"]
    voc = Vocoder(16, channels, 3, rates).eval()
    voc.load_state_dict(from_flax(params), strict=True)
    jpacked = jmm.pack_vocoder_weights(params, rates)
    mel = np.random.default_rng(7).normal(size=(2, 48, 16)).astype(np.float32)
    return rates, voc, jpacked, mel


def _flat(packed):
    out = [packed["input_conv"]["w"], packed["input_conv"]["b"]]
    for st in packed["stages"]:
        out += [st["tconv"]["w"], st["tconv"]["b"], st["res1"]["w"],
                st["res1"]["b"], st["res2"]["w"], st["res2"]["b"]]
    return out + [packed["output_conv"]["w"], packed["output_conv"]["b"]]


def test_packing_equals_jax(setup):
    rates, voc, jpacked, _ = setup
    tpacked = tmm.pack_vocoder_weights(voc)
    for a, b in zip(_flat(jpacked), _flat(tpacked)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for js, ts in zip(jpacked["stages"], tpacked["stages"]):
        assert (js["tconv"]["rate"], js["tconv"]["cout"]) == \
            (ts["tconv"]["rate"], ts["tconv"]["cout"])


@pytest.mark.parametrize("rate", [2, 4, 8])
def test_pack_tconv_matches_jax(rate):
    w = np.random.default_rng(rate).normal(size=(6, 4, 2 * rate)).astype(np.float32)
    b = np.arange(4, dtype=np.float32)
    ref = jmm.pack_tconv(jnp.asarray(w), jnp.asarray(b), rate)
    out = tmm.pack_tconv(torch.from_numpy(w), torch.from_numpy(b), rate)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(ref["w"]))
    # the zero tap blocks the fused kernel skips
    W = out["w"].numpy()
    for j in range(rate):
        cols = W[:, j * 4:(j + 1) * 4]
        dead = cols[12:18] if j < rate // 2 else cols[0:6]
        assert not dead.any()


def test_plain_and_module_equal_pallas_f32(setup):
    rates, voc, jpacked, mel = setup
    tpacked = tmm.pack_vocoder_weights(voc)
    ref_packed = np.asarray(pallas_packed(jnp.asarray(mel), jpacked, rates,
                                          tile=16, interpret=True))
    ref_padded = np.asarray(pallas_padded(jnp.asarray(mel), jpacked, rates,
                                          tile=16, interpret=True))
    with torch.no_grad():
        plain = tmm.vocoder_mm_forward(torch.from_numpy(mel), tpacked).numpy()
        module = voc(torch.from_numpy(mel))[..., 0].numpy()
    for out in (plain, module):
        np.testing.assert_allclose(out, ref_packed, **F32)
        np.testing.assert_allclose(out, ref_padded, **F32)


def test_plain_bf16_equals_pallas_bf16(setup):
    rates, voc, jpacked, mel = setup
    tpacked = tmm.pack_vocoder_weights(voc, "bf16")
    plain = tmm.vocoder_mm_forward(torch.from_numpy(mel), tpacked,
                                   "bf16").numpy()
    assert plain.dtype == np.float32
    for kernel in (pallas_packed, pallas_padded):
        ref = np.asarray(kernel(jnp.asarray(mel), jpacked, rates, tile=16,
                                interpret=True, compute_dtype="bf16"))
        err = np.abs(plain - ref)
        assert err.max() < BF16_MAX and err.mean() < BF16_MEAN


def test_wrapper_on_cpu_takes_plain_path(setup):
    rates, voc, _, mel = setup
    packed = tmm.pack_vocoder_weights(voc)
    before = cuda_vocoder.LAUNCHES
    out = cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel), packed,
                                             rates)
    assert cuda_vocoder.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(),
        tmm.vocoder_mm_forward(torch.from_numpy(mel), packed).numpy())


def test_wrapper_rejects_bad_input(setup):
    rates, voc, _, mel = setup
    packed = tmm.pack_vocoder_weights(voc)
    with pytest.raises(ValueError):
        cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel[..., :8]),
                                           packed, rates)
    with pytest.raises(ValueError):
        cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel).double(),
                                           packed, rates)
    with pytest.raises(ValueError):
        cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel), packed,
                                           rates[:-1])


def test_kernels_unavailable_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert build.kernels_available() is False


def test_cuda_backend_on_cpu_raises():
    model = M2TTS(hidden_dim=16, mel_channels=8, vocoder_channels=16,
                  text_encoder_layers=1, decoder_layers=1)
    with pytest.raises(ValueError):
        Synthesizer(model, vocoder_backend="cuda", device="cpu")
