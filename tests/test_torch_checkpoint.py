"""Checkpoints of the PyTorch port (``utils/checkpoint.py``): save and
restore, rotation, the ``best/`` pin, the EMA preference, a missing config;
``load_for_inference`` against the JAX package's on the same weights and
train-state layout (one saved by orbax, one by ``torch.save``), and
``from_checkpoint`` serving the PCM of the Synthesizer it was saved from,
exactly, and of the JAX package's ``from_checkpoint`` within ±1 LSB."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import build_model as jax_build_model
from m2tts_tpu.serving import pipeline as jpipeline
from m2tts_tpu.utils import checkpoint as jcheckpoint
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.models.tts_model import build_model
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.utils.checkpoint import (CheckpointManager,
                                              load_for_inference)
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

CFG = {
    "model": {
        "text_encoder": {"vocab_size": 256, "hidden_dim": 32,
                         "num_layers": 1, "num_heads": 2, "dropout": 0.0},
        "decoder": {"mel_channels": 16, "num_layers": 1},
        "vocoder": {"hidden_channels": 32, "upsample_rates": [4, 4, 2, 2]},
    },
    "data": {"sample_rate": 16000, "hop_length": 64},
}
BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
               batch_buckets=(1, 2, 4))
TEXTS = ["hello world", "the quick brown fox jumps"]
SCALE = 12.0


def _flax_params(seed):
    model = jax_build_model(JaxConfig(CFG).model)
    return jax.device_get(jax.jit(partial(
        model.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))["params"]


@pytest.fixture(scope="module")
def weights():
    return _flax_params(0), _flax_params(1)


def _sd_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_save_restore_roundtrip(tmp_path, weights):
    sd = from_flax(weights[0])
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=3)
    mgr.save(7, {"generator": sd, "step": 7, "lr": [1e-3, 2e-4]},
             config=Config(CFG), metrics={"val_loss": 0.5})
    state, cfg, step = mgr.restore()
    assert step == 7 and cfg == CFG
    assert state["step"] == 7 and state["lr"] == [1e-3, 2e-4]
    _sd_equal(state["generator"], sd)
    assert (tmp_path / "ckpt" / "7" / "metrics.json").exists()
    assert not [p for p in (tmp_path / "ckpt").iterdir()
                if p.name.startswith(".tmp")]
    mgr.close()
    # the model the config describes takes the state dict as it is
    build_model(cfg.model).load_state_dict(state["generator"], strict=True)


def test_rotation_keeps_newest(tmp_path, weights):
    sd = from_flax(weights[0])
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert mgr.latest_step() is None and mgr.best_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 2, 3):
        mgr.save(step, {"generator": sd, "step": step}, config=CFG)
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == mgr.best_step() == 3
    assert mgr.restore(2)[2] == 2
    with pytest.raises(FileNotFoundError):
        mgr.restore(1)
    mgr.save(3, {"generator": sd, "step": 30}, config=CFG)  # overwrite
    assert mgr.all_steps() == [2, 3] and mgr.restore()[0]["step"] == 30
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path / "other", max_to_keep=0)


@pytest.mark.parametrize("layout", ["generator", "generator_ema", "params"])
def test_load_for_inference_matches_jax(tmp_path, weights, layout):
    """The same train state saved by both packages loads to the same
    weights, config and step; the EMA copy is preferred when present."""
    p0, p1 = weights
    states = {
        "generator": lambda t: {"generator": t(p0), "step": 5},
        "generator_ema": lambda t: {"generator": t(p0),
                                    "generator_ema": t(p1), "step": 5},
        "params": lambda t: {"params": t(p1), "step": 5},
    }[layout]
    jmgr = jcheckpoint.CheckpointManager(tmp_path / "jax")
    jmgr.save(5, states(lambda p: p), config=JaxConfig(CFG))
    jmgr.close()
    CheckpointManager(tmp_path / "torch").save(5, states(from_flax),
                                               config=Config(CFG))
    jparams, jcfg, jstep = jcheckpoint.load_for_inference(tmp_path / "jax")
    sd, cfg, step = load_for_inference(tmp_path / "torch")
    assert step == jstep == 5
    assert cfg.to_dict() == jcfg.to_dict() == CFG
    _sd_equal(sd, from_flax(jparams))
    _sd_equal(sd, from_flax(p0 if layout == "generator" else p1))


def test_best_pin_and_missing_config(tmp_path, weights):
    sd = from_flax(weights[0])
    root = tmp_path / "ckpt"
    CheckpointManager(root).save(4, {"generator": sd}, config=CFG)
    with pytest.raises(FileNotFoundError, match="best"):
        load_for_inference(root, "best")
    CheckpointManager(root / "best", max_to_keep=1).save(
        3, {"generator_ema": from_flax(weights[1])}, config=CFG)
    best, _, step = load_for_inference(root, "best")
    assert step == 3
    _sd_equal(best, from_flax(weights[1]))
    assert load_for_inference(root)[2] == 4
    CheckpointManager(tmp_path / "bare").save(1, {"generator": sd})
    with pytest.raises(ValueError, match="config"):
        load_for_inference(tmp_path / "bare")
    with pytest.raises(FileNotFoundError):
        load_for_inference(tmp_path / "nowhere")


def test_from_checkpoint_serves_saved_weights(tmp_path, weights):
    synth = pipeline.from_config(CFG, seed=3, device="cpu", **BUCKETS)
    CheckpointManager(tmp_path / "ckpt").save(
        9, {"generator": synth.model.state_dict(), "step": 9},
        config=synth.config)
    loaded = pipeline.from_checkpoint(tmp_path / "ckpt", device="cpu",
                                      **BUCKETS)
    assert loaded.sample_rate == 16000 and loaded.hop_length == 64
    assert loaded.config == CFG
    for a, b in zip(synth.synthesize_batch(TEXTS, SCALE),
                    loaded.synthesize_batch(TEXTS, SCALE)):
        assert a["frames"] == b["frames"]
        np.testing.assert_array_equal(a["audio_pcm"], b["audio_pcm"])


def test_from_checkpoint_matches_jax(tmp_path, weights):
    p0 = weights[0]
    jmgr = jcheckpoint.CheckpointManager(tmp_path / "jax")
    jmgr.save(2, {"generator": p0, "step": 2}, config=JaxConfig(CFG))
    jmgr.close()
    CheckpointManager(tmp_path / "torch").save(
        2, {"generator": from_flax(p0), "step": 2}, config=CFG)
    js = jpipeline.from_checkpoint(str(tmp_path / "jax"), **BUCKETS)
    ts = pipeline.from_checkpoint(tmp_path / "torch", step=2, device="cpu",
                                  **BUCKETS)
    for r, o in zip(js.synthesize_batch(TEXTS, SCALE),
                    ts.synthesize_batch(TEXTS, SCALE)):
        assert r["frames"] == o["frames"]
        assert np.abs(r["audio_pcm"].astype(np.int32)
                      - o["audio_pcm"]).max(initial=0) <= 1
