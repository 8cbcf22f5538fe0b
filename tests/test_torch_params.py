"""Weight bridge of the PyTorch port: flax → torch → flax is exact, and the
port's modules take the converted state dict with no key left over. The
configs the port keeps as data equal their YAML files, and the checkpoint
manager lists a stored state's keys."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import build_model as jax_build_model
from m2tts_tpu.utils.config import load_config
from m2tts_tpu_torch.models.tts_model import build_model
from m2tts_tpu_torch.utils.checkpoint import CheckpointManager
from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL, FLAGSHIP_TRAINING,
                                          FLAGSHIP_XL_MODEL,
                                          FLAGSHIP_XL_TRAINING,
                                          STAGE2_TRAINING, STAGE2_XL_MODEL,
                                          STAGE2_XL_TRAINING)
from m2tts_tpu_torch.utils.params import from_flax, to_flax

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _model_cfg(name, norm=None):
    cfg = load_config(CONFIGS / name).model
    if norm is not None:
        cfg.set("duration_predictor.norm", norm)
    return cfg


def _flax_params(model_cfg):
    """The flax model's param tree (structure, shapes and dtypes from its
    ``init``, traced abstractly), filled with seeded normal values so that
    every element differs and a wrong layout shows."""
    model = jax_build_model(model_cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.array([8], jnp.int32), max_frames=16, run_vocoder=True))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize("name,norm", [("stage1_poc.yaml", None),
                                       ("flagship_tpu.yaml", None),
                                       ("stage1_poc.yaml", "batch")],
                         ids=["stage1_poc", "flagship", "batch_norm"])
def test_flax_torch_flax_roundtrip_exact(name, norm):
    cfg = _model_cfg(name, norm)
    params = _flax_params(cfg)
    sd = from_flax(params)
    model = build_model(cfg.to_dict())
    model.load_state_dict(sd, strict=True)  # every key matched, both ways
    back = to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_layouts():
    """Dense kernels transpose; conv kernels go (k, in, out) → (out, in, k);
    tconv kernels keep (in, out, k)."""
    params = _flax_params(_model_cfg("stage1_poc.yaml"))["params"]
    sd = from_flax(params)
    qkv = params["text_encoder"]["layer0"]["attn"]["qkv"]["kernel"]
    np.testing.assert_array_equal(
        sd["text_encoder.layer0.attn.qkv.weight"].numpy(), qkv.T)
    conv = params["vocoder"]["input_conv"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        sd["vocoder.input_conv.conv.weight"].numpy(), conv.transpose(2, 1, 0))
    tconv = params["vocoder"]["upsample0"]["kernel"]
    np.testing.assert_array_equal(sd["vocoder.upsample0.weight"].numpy(), tconv)


def test_flagship_model_matches_yaml():
    assert load_config(CONFIGS / "flagship_tpu.yaml").model.to_dict() \
        == FLAGSHIP_MODEL


@pytest.mark.parametrize("name,model,training", [
    ("flagship_tpu.yaml", FLAGSHIP_MODEL, FLAGSHIP_TRAINING),
    ("flagship_xl.yaml", FLAGSHIP_XL_MODEL, FLAGSHIP_XL_TRAINING)],
    ids=["flagship", "flagship_xl"])
def test_training_configs_match_yaml(name, model, training):
    cfg = load_config(CONFIGS / name)
    assert cfg.model.to_dict() == model
    assert {"training": cfg.training.to_dict(),
            "data": cfg.data.to_dict()} == training


@pytest.mark.parametrize("name,model,training", [
    ("stage2_quality.yaml", FLAGSHIP_MODEL, STAGE2_TRAINING),
    ("stage2_xl_quality.yaml", STAGE2_XL_MODEL, STAGE2_XL_TRAINING)],
    ids=["stage2", "stage2_xl"])
def test_stage2_configs_match_yaml(name, model, training):
    cfg = load_config(CONFIGS / name)
    assert cfg.model.to_dict() == model
    assert {"training": cfg.training.to_dict(), "data": cfg.data.to_dict(),
            "system": cfg.system.to_dict()} == training


def test_checkpoint_state_keys(tmp_path):
    """The top-level keys of a written step (the latest by default); None
    for a missing step, an empty directory and an unreadable file."""
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.state_keys() is None  # no checkpoint yet
    state = {"generator": {"w": torch.ones(3)}, "step": 4,
             "generator_ema": {"w": torch.zeros(3)}}
    mgr.save(4, state, config={"model": {}})
    mgr.save(6, {"generator": {"w": torch.ones(3)}, "step": 6})
    assert mgr.state_keys(4) == ["generator", "step", "generator_ema"]
    assert mgr.state_keys() == ["generator", "step"]
    assert mgr.state_keys(5) is None
    (tmp_path / "ckpt/6/state.pt").write_bytes(b"\x00 not a torch file")
    assert mgr.state_keys(6) is None
    assert mgr.state_keys(4) == ["generator", "step", "generator_ema"]
