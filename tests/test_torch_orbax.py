"""``tools/orbax_to_torch.py`` on stage-1 runs of the JAX package, on the
CPU at a tiny size (1 layer, 32-d, 8 mel bins, dropout 0): a 2-step JAX
stage-1 run saved by orbax (its latest step and its ``best/`` pin with
``score.json``) and converted

- resumes in the port's ``Stage1Trainer`` (``train(resume=True)``) at step
  2 with JAX's best score, and its third step equals JAX's step 3: the
  loss within 1e-5 relative, the params within 1e-6 (the bar of
  ``tests/test_torch_train.py``; Adam's moments and count come through
  ``optimizer_state_from_optax`` from orbax's dict form);
- served by the port's ``from_checkpoint`` (latest and ``best``) is within
  ±1 LSB of the JAX ``from_checkpoint``'s PCM, with equal frames;
- seeds the port's stage-2 ``init_generator_from`` with JAX's weights,
  exactly;

and ``optimizer_state_from_optax`` reads the lists and dicts orbax
restores without a template (Adam, and MultiSteps mid-accumulation) to
the values it reads from optax's named tuples.

The stage-2 payload is held in ``tests/test_torch_orbax_stage2.py``.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
from m2tts_tpu.data.dataset import make_batches as jax_make_batches
from m2tts_tpu.serving import pipeline as jpipeline
from m2tts_tpu.training import trainer as jtrainer
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.data.dataset import DummyDataset
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.training.trainer import Stage1Trainer
from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
from m2tts_tpu_torch.utils.checkpoint import CheckpointManager
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.orbax_to_torch import convert  # noqa: E402

torch.set_num_threads(2)

DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0)
PARAMS_ATOL = 1e-6
BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
               batch_buckets=(1, 4))
TEXTS = ["hello world", "the quick brown fox jumps", "a"]
BEST_SCORE = 1.25


def tiny_config(root: Path, **training):
    t = {"batch_size": 8, "max_steps": 2, "learning_rate": 1e-3,
         "warmup_steps": 0, "lr_scheduler": "constant",
         "gradient_clip_norm": 1.0, "bf16": False, "log_every": 1,
         "save_every": 100, "validate_every": 100, "max_checkpoints": 2,
         "seed": 0, "validate_samples": False}
    t.update(training)
    return {
        "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                                   "num_layers": 1, "num_heads": 2,
                                   "dropout": 0.0},
                  "decoder": {"mel_channels": 8, "num_layers": 1},
                  "vocoder": {"hidden_channels": 32}},
        "training": t,
        "data": {"buckets": [[48, 128]], "n_mels": 8},
        "system": {"mesh": {"data": -1}, "log_metrics": "jsonl"},
        "paths": {"output_dir": str(root / "out"),
                  "checkpoint_dir": str(root / "out/ckpt"),
                  "log_dir": str(root / "out/logs")},
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 2-step JAX stage-1 run saved by orbax (latest and best/), JAX's
    third step, and the converted checkpoint dir."""
    root = tmp_path_factory.mktemp("orbax_stage1")
    jt = jtrainer.Stage1Trainer(JaxConfig(tiny_config(root / "jax")),
                                dataset=JaxDummyDataset(**DS_KW))
    batches = list(jax_make_batches(JaxDummyDataset(**DS_KW), 8,
                                    jt.buckets, seed=5))
    rng = jax.random.PRNGKey(0)
    state = jt.state
    for b in batches[:2]:
        state, _ = jt._train_step(state, jt._put(b), rng)
    jt.state, jt.step = state, 2
    jt.save_checkpoint()
    jt.save_best_checkpoint(BEST_SCORE)
    jt.close()
    step2 = from_flax(jax.device_get(state.params))
    state3, losses3 = jt._train_step(state, jt._put(batches[2]), rng)
    src = root / "jax/out/ckpt"
    dst = root / "converted"
    done = convert(src, dst)
    return {"src": src, "dst": dst, "done": done, "batch3": batches[2],
            "root": root, "step2": step2,
            "params3": from_flax(jax.device_get(state3.params)),
            "loss3": float(losses3["total_loss"])}


def test_layout(run):
    assert run["done"] == {"steps": [2], "best": [2]}
    dst = run["dst"]
    assert (dst / "2/state.pt").exists() and (dst / "2/config.json").exists()
    assert (dst / "best/2/state.pt").exists()
    score = json.loads((dst / "best/score.json").read_text())
    assert score["score"] == BEST_SCORE
    assert score["metric"] == "val_total_loss"
    assert sorted(CheckpointManager(dst).state_keys()) == [
        "opt_state", "params", "step"]
    state, config, step = CheckpointManager(dst).restore()
    assert step == state["step"] == 2
    assert config.to_dict()["model"] == tiny_config(run["root"])["model"]
    assert state["opt_state"]["count"] == 2
    for k, v in run["step2"].items():
        assert torch.equal(state["params"][k], v), k


def test_resumes_to_jax_step_3(run):
    cfg = tiny_config(run["root"] / "port")
    cfg["paths"]["checkpoint_dir"] = str(run["dst"])
    pt = Stage1Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                       device="cpu")
    pt.train(resume=True)  # max_steps reached: restore, then exit
    assert pt.step == 2 and pt.optimizer.count == 2
    assert pt.best_val_loss == pytest.approx(BEST_SCORE)
    tl = pt._train_step(pt._put(run["batch3"]))
    np.testing.assert_allclose(tl["total_loss"].item(), run["loss3"],
                               rtol=1e-5)
    assert pt.optimizer.count == 3
    got = pt.model.state_dict()
    assert set(got) == set(run["params3"])
    for k, ref in run["params3"].items():
        torch.testing.assert_close(got[k], ref, rtol=0, atol=PARAMS_ATOL,
                                   msg=k)
    pt.close()


@pytest.mark.parametrize("step", [None, "best"], ids=["latest", "best"])
def test_served_within_one_lsb_of_jax(run, step):
    js = jpipeline.from_checkpoint(str(run["src"]), step=step, **BUCKETS)
    ts = pipeline.from_checkpoint(run["dst"], step=step, device="cpu",
                                  **BUCKETS)
    assert (ts.vocoder_backend, ts.compute_dtype) == ("torch", "f32")
    for ref, got in zip(js.synthesize_batch(TEXTS, 12.0),
                        ts.synthesize_batch(TEXTS, 12.0)):
        assert got["frames"] == ref["frames"] > 0
        assert np.abs(got["audio_pcm"].astype(np.int32)
                      - ref["audio_pcm"]).max() <= 1


def test_seeds_init_generator_from(run):
    cfg = tiny_config(run["root"] / "stage2",
                      init_generator_from=str(run["dst"]),
                      audio_segment_len=512)
    cfg["data"]["hop_length"] = 256
    t2 = Stage2Trainer(Config(cfg), dataset=DummyDataset(**DS_KW,
                                                         keep_audio=True),
                       device="cpu")
    got = t2.model.state_dict()
    assert set(got) == set(run["step2"])
    for k, v in run["step2"].items():
        assert torch.equal(got[k], v), k
    t2.close()


@pytest.mark.parametrize("k", [1, 2], ids=["adam", "multisteps_k2"])
def test_optax_state_from_orbax_raw_restore(tmp_path, k):
    """orbax restores an optax state without a template as lists and
    dicts; ``optimizer_state_from_optax`` reads that form as it reads the
    named tuples, to the same values (3 updates; at k = 2 mid-accumulation,
    so ``acc_grads`` and ``mini_step`` are live)."""
    import optax
    import orbax.checkpoint as ocp

    from m2tts_tpu_torch.utils.params import optimizer_state_from_optax

    cfg = JaxConfig({"learning_rate": 1e-2, "warmup_steps": 0,
                     "max_steps": 10, "gradient_clip_norm": 1.0,
                     "gradient_accumulation_steps": k})
    rng = np.random.default_rng(0)
    shapes = {"w0": (3, 4), "w1": (5,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    tx = jtrainer.make_optimizer(cfg)
    state = tx.init(params)
    for _ in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32)
                 for n, s in shapes.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "opt", jax.device_get(state))
    ckptr.wait_until_finished()
    raw = ckptr.restore(tmp_path / "opt")
    module = torch.nn.ParameterDict(
        {n: torch.nn.Parameter(torch.zeros(s)) for n, s in shapes.items()})
    want = optimizer_state_from_optax(jax.device_get(state), module)
    got = optimizer_state_from_optax(raw, module)
    assert (got["count"], got["mini_step"]) == (want["count"],
                                                want["mini_step"])
    assert want["count"] == 3 // k and want["mini_step"] == 3 % k
    for key in ("mu", "nu") + (("acc_grads",) if k > 1 else ()):
        assert set(got[key]) == set(want[key]) == set(shapes)
        for n in shapes:
            assert torch.equal(got[key][n], want[key][n]), (key, n)
