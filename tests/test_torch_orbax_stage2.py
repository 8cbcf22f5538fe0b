"""``tools/orbax_to_torch.py`` on a stage-2 (GAN) run of the JAX package,
on the CPU at the tiny size of ``tests/test_torch_stage2_step.py`` (1
layer, 32-d, 8 mel bins, a 32-channel vocoder, 512-sample segments, batch
8, dropout 0, spectral norm, envelope loss, EMA 0.5, phase weight 0): a
2-step JAX run saved by orbax and converted holds every key of the port's
stage-2 checkpoint (``generator``, ``g_opt_state``, ``discriminator``,
``d_opt_state``, ``step``, ``generator_ema``), resumes in the port's
``Stage2Trainer`` (``restore()``) at step 2, and its third step equals
JAX's step 3: every logged loss within 1e-5 relative, both nets and the
EMA within lr/10 (the bars of ``test_torch_stage2_step.py``). Both
trainers draw their segments from ``default_rng(seed + 2)``; neither
checkpoint holds that stream, so the port continues from the state of
JAX's generator after its two steps."""

import copy
import itertools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
from m2tts_tpu.data.dataset import data_iterator as jax_data_iterator
from m2tts_tpu.training import trainer_stage2 as jstage2
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.data.dataset import DummyDataset
from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
from m2tts_tpu_torch.utils.checkpoint import CheckpointManager
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.orbax_to_torch import convert  # noqa: E402

torch.set_num_threads(2)

DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0, keep_audio=True)
LR = 1e-3
PARAMS_ATOL = LR / 10
KEYS = ["d_opt_state", "discriminator", "g_opt_state", "generator",
        "generator_ema", "step"]


def tiny_config(root: Path):
    return {
        "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                                   "num_layers": 1, "num_heads": 2,
                                   "dropout": 0.0},
                  "decoder": {"mel_channels": 8, "num_layers": 1},
                  "vocoder": {"hidden_channels": 32}},
        "training": {"batch_size": 8, "max_steps": 2, "learning_rate": LR,
                     "warmup_steps": 0, "lr_scheduler": "constant",
                     "gradient_clip_norm": 1.0, "bf16": False,
                     "audio_segment_len": 512, "log_every": 1,
                     "save_every": 100, "validate_every": 100, "seed": 0,
                     "stft_phase_weight": 0.0,
                     "discriminator_spectral_norm": True,
                     "envelope_loss_weight": 4.0, "ema_decay": 0.5,
                     "validate_quality": False},
        "data": {"buckets": [[48, 128]], "n_mels": 8, "hop_length": 256},
        "system": {"mesh": {"data": -1}, "log_metrics": "jsonl"},
        "paths": {"output_dir": str(root / "out"),
                  "checkpoint_dir": str(root / "out/ckpt"),
                  "log_dir": str(root / "out/logs")},
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax_stage2")
    jt = jstage2.Stage2Trainer(JaxConfig(tiny_config(root / "jax")),
                               dataset=JaxDummyDataset(**DS_KW))
    batches = list(itertools.islice(jax_data_iterator(
        JaxDummyDataset(**DS_KW), 8, jt.buckets, seed=0,
        audio_samples=jt._max_audio_samples()), 3))
    for b in batches[:2]:
        jt.train_step(b)
    assert jt.step == 2
    jt.save_checkpoint()
    seg_rng = copy.deepcopy(jt._host_rng)
    metrics3 = {k: float(v) for k, v in jt.train_step(batches[2]).items()}
    dst = root / "converted"
    done = convert(root / "jax/out/ckpt", dst)
    out = {"dst": dst, "done": done, "root": root, "batch3": batches[2],
           "seg_rng": seg_rng, "metrics3": metrics3,
           "generator": from_flax(jax.device_get(jt.g_state.params)),
           "discriminator": from_flax(jax.device_get(jt.d_state.params)),
           "ema": from_flax(jax.device_get(jt.ema_params))}
    jt.close()
    return out


def test_layout(run):
    assert run["done"] == {"steps": [2]}
    state, _, step = CheckpointManager(run["dst"]).restore()
    assert sorted(state) == KEYS and step == state["step"] == 2
    for key in ("g_opt_state", "d_opt_state"):
        assert state[key]["count"] == 2 and state[key]["mu"]


def _max_abs(got, ref):
    assert set(got) == set(ref)
    return max(float((got[k] - ref[k]).abs().max()) for k in ref)


def test_resumes_to_jax_step_3(run):
    cfg = tiny_config(run["root"] / "port")
    cfg["paths"]["checkpoint_dir"] = str(run["dst"])
    pt = Stage2Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                       device="cpu")
    pt.restore()
    assert pt.step == pt.g_updates == pt.d_updates == 2
    pt._host_rng = run["seg_rng"]
    mp = {k: v.item() for k, v in pt.train_step(run["batch3"]).items()}
    assert set(mp) == set(run["metrics3"])
    for k, v in run["metrics3"].items():
        np.testing.assert_allclose(mp[k], v, rtol=1e-5, err_msg=k)
    assert _max_abs(pt.model.state_dict(), run["generator"]) <= PARAMS_ATOL
    assert _max_abs(pt.discriminator.state_dict(),
                    run["discriminator"]) <= PARAMS_ATOL
    ema = dict(zip(pt.g_names, pt.ema))
    assert _max_abs(ema, {n: run["ema"][n] for n in pt.g_names}) \
        <= PARAMS_ATOL
    pt.close()
