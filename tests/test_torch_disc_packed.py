"""The phase-packed discriminator of the PyTorch port
(``models/discriminator.packed_multiscale_apply``) against the JAX
package's ``packed_multiscale_apply`` and against the port's own
``MultiScaleDiscriminator`` module, on the CPU at the full discriminator
(three scales, 16.76 M parameters), the JAX init carried over by
``from_flax``, the inputs from ``numpy.random.default_rng``:

- outputs (logits and the 18 feature maps) on [2, 2048] within 1e-4, the
  bar of ``tests/test_disc_packed.py``;
- the gradients of the weights and of the input on [2, 1024] within 1e-5;
- each weight-gradient lowering (``xla``, ``pergroup``, ``dense``) against
  JAX's packed gradients within 5e-4, the bar within which
  ``tests/test_grouped_conv_wgrad.py`` holds JAX's lowerings to each other
  (``test_torch_grouped_conv.py`` holds each against JAX's same one);
- a length of 1002, whose scale ×2 and ×4 inputs do not divide by the
  stride at some layer: those layers run the plain conv, as in JAX;
- bf16 within 0.05 (abs and rel), under oneDNN disabled (its bf16 CPU
  convs give NaN in the discriminator, ``test_torch_stage2_step.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import discriminator as jdisc
from m2tts_tpu_torch.models import discriminator as tdisc
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nets():
    """(JAX params, port module on them, the module's parameter dict)."""
    params = jdisc.MultiScaleDiscriminator().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1), jnp.float32))["params"]
    module = tdisc.MultiScaleDiscriminator()
    module.load_state_dict(from_flax(jax.device_get(params)))
    return params, module, dict(module.named_parameters())


def _audio(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flat(logits, feats):
    return [np.asarray(a, np.float32) for a in logits] + [
        np.asarray(a, np.float32) for fs in feats for a in fs]


def _torch_flat(logits, feats):
    return _flat([l.detach().float().numpy() for l in logits],
                 [[f.detach().float().numpy() for f in fs] for fs in feats])


def _assert_all_close(got, want, **tol):
    assert len(got) == len(want) == 3 + 18
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, err_msg=f"output {i}", **tol)


@pytest.mark.parametrize("ref", ["jax_packed", "port_native"])
def test_packed_outputs_match(nets, ref):
    params, module, tparams = nets
    audio = _audio((2, 2048), 0)
    with torch.no_grad():
        got = _torch_flat(*tdisc.packed_multiscale_apply(
            tparams, torch.from_numpy(audio)))
        if ref == "jax_packed":
            want = _flat(*jdisc.packed_multiscale_apply(params,
                                                        jnp.asarray(audio)))
        else:
            want = _torch_flat(*module(torch.from_numpy(audio)))
    _assert_all_close(got, want, atol=1e-4)


def _port_grads(module, tparams, audio, packed, wgrad="xla"):
    x = torch.from_numpy(audio).requires_grad_()
    if packed:
        logits, feats = tdisc.packed_multiscale_apply(tparams, x, wgrad=wgrad)
    else:
        logits, feats = module(x)
    loss = (sum((l ** 2).mean() for l in logits)
            + sum(f.abs().mean() for fs in feats for f in fs))
    grads = torch.autograd.grad(loss, [x] + list(tparams.values()))
    return grads[0].numpy(), {k: g.numpy() for k, g in
                              zip(tparams, grads[1:])}


def _jax_grads(params, audio, wgrad="xla"):
    def loss(p, x):
        logits, feats = jdisc.packed_multiscale_apply(p, x, wgrad=wgrad)
        return (sum(jnp.mean(l ** 2) for l in logits)
                + sum(jnp.mean(jnp.abs(f)) for fs in feats for f in fs))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(audio))
    return np.asarray(gx), {k: v.numpy() for k, v in
                            from_flax(jax.device_get(gp)).items()}


@pytest.fixture(scope="module")
def grads_1024(nets):
    params, module, tparams = nets
    audio = _audio((2, 1024), 1)
    return {"audio": audio,
            "port_packed": _port_grads(module, tparams, audio, True),
            "port_native": _port_grads(module, tparams, audio, False),
            "jax_packed": _jax_grads(params, audio)}


@pytest.mark.parametrize("ref", ["jax_packed", "port_native"])
def test_packed_gradients_match(grads_1024, ref):
    gx, gw = grads_1024["port_packed"]
    rx, rw = grads_1024[ref]
    np.testing.assert_allclose(gx, rx, atol=1e-5)
    assert set(gw) == set(rw) and len(gw) == 3 * 14
    for k in rw:
        np.testing.assert_allclose(gw[k], rw[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("wgrad", ["xla", "pergroup", "dense"])
def test_wgrad_variants_match_jax(nets, grads_1024, wgrad):
    _, module, tparams = nets
    gx, gw = _port_grads(module, tparams, grads_1024["audio"], True, wgrad)
    rx, rw = grads_1024["jax_packed"]
    np.testing.assert_allclose(gx, rx, rtol=5e-4, atol=5e-4)
    for k in rw:
        np.testing.assert_allclose(gw[k], rw[k], rtol=5e-4, atol=5e-4,
                                   err_msg=k)


def test_indivisible_length_runs_the_plain_conv(nets, monkeypatch):
    params, module, tparams = nets
    audio = _audio((1, 1002), 2)
    strides = []
    plain = tdisc._plain_conv
    monkeypatch.setattr(tdisc, "_plain_conv", lambda x, w, b, s, g: (
        strides.append(s) or plain(x, w, b, s, g)))
    with torch.no_grad():
        got = _torch_flat(*tdisc.packed_multiscale_apply(
            tparams, torch.from_numpy(audio)))
        native = _torch_flat(*module(torch.from_numpy(audio)))
    # 1002 % 4 != 0 at scale 1's first strided layer; scale 2 (501) too
    assert any(s > 1 for s in strides)
    want = _flat(*jdisc.packed_multiscale_apply(params, jnp.asarray(audio)))
    _assert_all_close(got, want, atol=1e-4)
    _assert_all_close(got, native, atol=1e-4)


def test_packed_bf16_matches(nets):
    params, module, tparams = nets
    audio = _audio((2, 1024), 3)
    p16 = {k: v.detach().to(torch.bfloat16) for k, v in tparams.items()}
    x16 = torch.from_numpy(audio).to(torch.bfloat16)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = _torch_flat(*tdisc.packed_multiscale_apply(p16, x16))
        native = _torch_flat(*torch.func.functional_call(module, p16, (x16,)))
    j16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want = _flat(*jdisc.packed_multiscale_apply(
        j16, jnp.asarray(audio).astype(jnp.bfloat16)))
    _assert_all_close(got, want, atol=0.05, rtol=0.05)
    _assert_all_close(got, native, atol=0.05, rtol=0.05)


def test_unknown_wgrad_raises(nets):
    _, _, tparams = nets
    with pytest.raises(ValueError, match="wgrad"):
        tdisc.packed_multiscale_apply(tparams, torch.zeros(1, 1024),
                                      wgrad="magic")
