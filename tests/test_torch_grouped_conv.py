"""The weight-gradient lowerings of the PyTorch port
(``ops/grouped_conv.conv1d_s1``) and the phase-packing of a strided conv
(``models/discriminator._packed_strided_conv``), on the CPU:

- ``conv1d_s1`` with each variant (``xla``, ``pergroup``, ``dense``) at
  the four packed discriminator layers' shapes (groups, input and output
  channels a group: (4, 16, 32), (16, 8, 16), (64, 4, 8), (256, 2, 4)
  before packing; 11 taps, padding (5, 5) after) and at a k=15, s=4 layer
  (4 taps, padding (2, 1)): the output, the input gradient and the weight
  gradient against the port's ``xla`` path and against JAX's
  ``conv1d_s1`` with the same variant, within 5e-4 (the bar of
  ``tests/test_grouped_conv_wgrad.py``);
- ``_packed_strided_conv`` against the plain strided conv at (k, s) =
  (41, 4), (15, 4) and (5, 2), outputs and gradients, for every variant;
- an unknown variant raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.ops import grouped_conv as jgc
from m2tts_tpu_torch.models.discriminator import (_packed_strided_conv,
                                                  _plain_conv)
from m2tts_tpu_torch.ops import grouped_conv as tgc

torch.set_num_threads(2)

TOL = {"rtol": 5e-4, "atol": 5e-4}
# (groups, in, out channels a group before packing, k, stride)
LAYERS = {"conv1": (4, 16, 32, 41, 4), "conv2": (16, 8, 16, 41, 4),
          "conv3": (64, 4, 8, 41, 4), "conv4": (256, 2, 4, 41, 4),
          "k15_s4": (4, 16, 32, 15, 4)}


def _packed_problem(groups, ci, co, k, s, seed=0):
    """(x [B, Cin·s, T], w [Cout, ci·s, kp], pad, cotangent) of the stride-1
    conv that packing makes of the layer."""
    pad = (k - 1) // 2
    r_lo, r_hi = (0 - pad) // s, (k - 1 - pad) // s
    kp = r_hi - r_lo + 1
    rng = np.random.default_rng(seed)
    B, T = 2, 12
    x = rng.standard_normal((B, groups * ci * s, T)).astype(np.float32)
    w = (rng.standard_normal((groups * co, ci * s, kp))
         / np.sqrt(ci * s * kp)).astype(np.float32)
    dy = rng.standard_normal((B, groups * co, T)).astype(np.float32)
    return x, w, (-r_lo, r_hi), dy


def _port(x, w, pad, groups, dy, variant):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tgc.conv1d_s1(xt, wt, pad, groups, variant)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


def _jax(x, w, pad, groups, dy, variant):
    """JAX's conv1d_s1 in its [B, T, C] / [k, ci, Cout] layout, results in
    the port's."""
    xj = jnp.asarray(x.transpose(0, 2, 1))
    wj = jnp.asarray(w.transpose(2, 1, 0))
    y, vjp = jax.vjp(lambda a, b: jgc.conv1d_s1(a, b, pad, groups, variant),
                     xj, wj)
    dx, dw = vjp(jnp.asarray(dy.transpose(0, 2, 1)))
    return (np.asarray(y).transpose(0, 2, 1), np.asarray(dx).transpose(0, 2, 1),
            np.asarray(dw).transpose(2, 1, 0))


@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("variant", ["xla", "pergroup", "dense"])
def test_conv1d_s1_matches_xla_path_and_jax(layer, variant):
    groups, ci, co, k, s = LAYERS[layer]
    x, w, pad, dy = _packed_problem(groups, ci, co, k, s)
    got = _port(x, w, pad, groups, dy, variant)
    xla = _port(x, w, pad, groups, dy, "xla")
    want = _jax(x, w, pad, groups, dy, variant)
    for name, a, b, c in zip(("y", "dx", "dw"), got, xla, want):
        assert a.shape == b.shape == c.shape, name
        np.testing.assert_allclose(a, b, err_msg=f"{name} vs xla", **TOL)
        np.testing.assert_allclose(a, c, err_msg=f"{name} vs JAX", **TOL)


@pytest.mark.parametrize("k,s", [(41, 4), (15, 4), (5, 2)])
@pytest.mark.parametrize("variant", ["xla", "pergroup", "dense"])
def test_packed_strided_conv_equals_the_strided_conv(k, s, variant):
    groups, ci, co = 4, 4, 8
    rng = np.random.default_rng(k * 10 + s)
    x = torch.from_numpy(rng.standard_normal(
        (2, groups * ci, 16 * s)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((groups * co, ci, k))
                          / np.sqrt(ci * k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(groups * co).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(
        (2, groups * co, 16)).astype(np.float32))
    outs = []
    for packed in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = (_packed_strided_conv(*leaves, s, groups, wgrad=variant) if packed
             else _plain_conv(*leaves, s, groups))
        assert y.shape == dy.shape
        outs.append((y.detach(), torch.autograd.grad(y, leaves, dy)))
    (yp, gp), (yn, gn) = outs
    torch.testing.assert_close(yp, yn, rtol=1e-5, atol=1e-5)
    for name, a, c in zip(("dx", "dw", "db"), gp, gn):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5, msg=name)


def test_unknown_variant_raises():
    x, w = torch.zeros(1, 4, 8), torch.zeros(4, 1, 3)
    with pytest.raises(ValueError, match="unknown wgrad variant 'magic'"):
        tgc.conv1d_s1(x, w, (1, 1), 4, "magic")
