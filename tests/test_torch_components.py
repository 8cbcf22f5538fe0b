"""Each building block of the PyTorch port against its flax counterpart:
the same numpy inputs and the same (randomised) weights, f32,
atol 3e-5 / rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import components as jc
from m2tts_tpu_torch.models import components as tc
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

TOL = dict(atol=3e-5, rtol=1e-4)


def _random_params(params, seed=0):
    """Every leaf redrawn, so zero-initialised biases and BatchNorm stats
    are exercised too; variances kept positive."""
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        a = rng.normal(scale=0.3, size=leaf.shape).astype(np.float32)
        if "bn_var" in jax.tree_util.keystr(path):
            a = np.abs(a) + 0.5
        leaves.append(a)
    return jax.tree_util.tree_unflatten(tree, leaves)


def _check(flax_mod, torch_mod, inputs, torch_inputs=None, **apply_kw):
    params = flax_mod.init(jax.random.PRNGKey(0),
                           *[jnp.asarray(x) for x in inputs], **apply_kw)
    params = _random_params(params)
    ref = np.asarray(flax_mod.apply(params, *[jnp.asarray(x) for x in inputs],
                                    **apply_kw))
    torch_mod.load_state_dict(from_flax(params), strict=True)
    torch_mod.eval()
    if torch_inputs is None:
        torch_inputs = [torch.from_numpy(np.asarray(x)) for x in inputs]
    with torch.no_grad():
        out = torch_mod(*torch_inputs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)
    return out


@pytest.mark.parametrize("max_len,dim", [(64, 16), (33, 15)])
def test_position_encoding(max_len, dim):
    ref = np.asarray(jc.sinusoidal_position_encoding(max_len, dim))
    out = tc.sinusoidal_position_encoding(max_len, dim).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_padding_mask():
    lengths = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(
        tc.padding_mask(torch.from_numpy(lengths), 7).numpy(),
        np.asarray(jc.padding_mask(jnp.asarray(lengths), 7)))


def test_attention_with_length_zero_rows(rng):
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([7, 3, 0])[:, None]
    out = _check(jc.MultiHeadSelfAttention(16, 2), tc.MultiHeadSelfAttention(16, 2),
                 [x, mask])
    # an all-padding row attends uniformly (scores replaced, not added)
    assert np.isfinite(out).all()


def test_attention_unmasked(rng):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    fm, tm = jc.MultiHeadSelfAttention(16, 4), tc.MultiHeadSelfAttention(16, 4)
    _check(fm, tm, [x])


def test_feedforward(rng):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    _check(jc.FeedForward(16, 32), tc.FeedForward(16, 32), [x])


def test_transformer_layer(rng):
    x = rng.normal(size=(3, 6, 16)).astype(np.float32)
    mask = np.arange(6)[None, :] < np.array([6, 2, 0])[:, None]
    _check(jc.TransformerEncoderLayer(16, 2, 32),
           tc.TransformerEncoderLayer(16, 2, 32), [x, mask])


@pytest.mark.parametrize("k,d", [(3, 1), (1, 1), (5, 1), (3, 2)])
def test_conv1d(rng, k, d):
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    _check(jc.Conv1d(8, k, dilation=d), tc.Conv1d(6, 8, k, dilation=d), [x])


@pytest.mark.parametrize("r", [2, 4, 8])
def test_conv_transpose(rng, r):
    x = rng.normal(size=(2, 9, 8)).astype(np.float32)
    out = _check(jc.ConvTranspose1d(8, 4, 2 * r, r, r // 2),
                 tc.ConvTranspose1d(8, 4, 2 * r, r, r // 2), [x])
    assert out.shape == (2, 9 * r, 4)


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_conv_block(rng, norm):
    x = rng.normal(size=(2, 9, 8)).astype(np.float32)
    _check(jc.ConvBlock(8, 3, norm=norm), tc.ConvBlock(8, 8, 3, norm=norm), [x])


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_variance_predictor(rng, norm):
    x = rng.normal(size=(2, 9, 8)).astype(np.float32)
    out = _check(jc.VariancePredictor(8, norm=norm),
                 tc.VariancePredictor(8, norm=norm), [x])
    assert out.shape == (2, 9)


def test_resblock(rng):
    x = rng.normal(size=(2, 13, 8)).astype(np.float32)
    _check(jc.LightweightResBlock(8), tc.LightweightResBlock(8), [x])


def test_conv_block_rejects_unknown_norm():
    with pytest.raises(ValueError):
        tc.ConvBlock(4, 4, norm="group")
