"""The stage-2 trainer of the PyTorch port around its step, on the CPU at a
tiny size:

- ``validate()`` against the JAX trainer's on the same weights: the same
  keys, every value within 1e-5 relative (STOI, near 0 for untrained
  weights, within 1e-6 absolute), the MR-STFT loss at its phase weight 0.1
  within 1e-3 (its angle at the frames centred on a segment's ends is ±pi
  by the sign of a rounding error, see ``test_torch_stage2_blocks.py``;
  measured 1.4e-4); and equal across two calls, leaving the training
  segment stream where it was;
- resume: a trainer restored from a step-2 checkpoint takes the same step
  3 as the trainer that wrote it (losses, weights, optimizer states and
  EMA bit-equal); a checkpoint without ``generator_ema`` resumes with the
  EMA seeded from the generator whether ``state_keys()`` lists the keys or
  cannot read them, and a corrupt ``state.pt`` raises;
- ``best/`` pinned with the raw generator, its optimizer state and the
  EMA, served by ``from_checkpoint`` at 0 LSB against the in-memory EMA;
- ``init_generator_from`` a port stage-1 checkpoint;
- the OOM guard, the bounded blow-up rewind (restored before the raise)
  and the refusal to checkpoint non-finite weights;
- the device cache's windows, ``disc_lowering`` (``packed`` gives the
  module's logits and features within 1e-4), the mesh guard, the
  warning for ``alternate_gd`` with the adversarial guard, and the CLI.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
from m2tts_tpu.training import trainer_stage2 as jstage2
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.data.dataset import DummyDataset, make_batches
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.training import trainer_stage2 as tstage2
from m2tts_tpu_torch.training.train_stage2 import main as cli_main
from m2tts_tpu_torch.training.trainer import Stage1Trainer
from m2tts_tpu_torch.utils.checkpoint import load_for_inference
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0, keep_audio=True)
BUCKETS = dict(text_buckets=(16,), frame_buckets=(64,), batch_buckets=(2,))
TEXTS = ["hello world", "a test"]


def tiny_config(tmp_path, dropout=0.1, **training):
    t = {"batch_size": 8, "max_steps": 2, "learning_rate": 1e-3,
         "warmup_steps": 0, "lr_scheduler": "constant",
         "gradient_clip_norm": 1.0, "bf16": False, "audio_segment_len": 512,
         "log_every": 1, "save_every": 100, "validate_every": 100,
         "seed": 0, "validate_quality": False}
    t.update(training)
    return {
        "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                                   "num_layers": 1, "num_heads": 2,
                                   "dropout": dropout},
                  "decoder": {"mel_channels": 8, "num_layers": 1},
                  "vocoder": {"hidden_channels": 32}},
        "training": t,
        "data": {"buckets": [[48, 128]], "n_mels": 8, "hop_length": 256},
        "system": {"mesh": {"data": -1}, "log_metrics": "jsonl",
                   "eval_texts": ["Hello."], "eval_text_bucket": 16,
                   "eval_frame_bucket": 64},
        "paths": {"output_dir": str(tmp_path / "out"),
                  "checkpoint_dir": str(tmp_path / "out/ckpt"),
                  "log_dir": str(tmp_path / "out/logs")},
    }


def port(cfg, **kw):
    return tstage2.Stage2Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                                 device="cpu", **kw)


def _state(t):
    """Every tensor a resume must restore, as host copies."""
    out = {f"g.{k}": v.clone() for k, v in t.model.state_dict().items()}
    out.update({f"d.{k}": v.clone()
                for k, v in t.discriminator.state_dict().items()})
    for name, opt in (("gopt", t.g_opt), ("dopt", t.d_opt)):
        st = opt.state_dict()
        for m in ("mu", "nu"):
            out.update({f"{name}.{m}.{k}": v.clone()
                        for k, v in st[m].items()})
    if t.ema is not None:
        out.update({f"ema.{n}": e.clone() for n, e in zip(t.g_names, t.ema)})
    return out


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _fixed_batch(t, seed=5):
    """One device batch with its segments drawn from its own generator."""
    host = next(make_batches(t.dataset, 8, t.buckets, seed=seed,
                             audio_samples=t._max_audio_samples()))
    return t._transfer.transfer(t._prepare(host, np.random.default_rng(seed)))


# -- validation --------------------------------------------------------------

def test_validate_matches_jax_and_is_deterministic(tmp_path):
    cfg = tiny_config(tmp_path, dropout=0.0, validate_quality=True,
                      quality_utterances=4)
    jt = jstage2.Stage2Trainer(JaxConfig(tiny_config(tmp_path / "jax",
                                                     **cfg["training"])),
                               dataset=JaxDummyDataset(**DS_KW))
    pt = port(cfg)
    pt.model.load_state_dict(from_flax(jax.device_get(jt.g_state.params)))
    want = jt.validate(n_batches=1)
    rng_state = pt._host_rng.bit_generator.state
    got = pt.validate(n_batches=1)
    again = pt.validate(n_batches=1)
    assert pt._host_rng.bit_generator.state == rng_state
    assert got == again
    assert set(got) == set(want)
    assert {"quality_score_audio", "utt_stoi", "mcd", "stoi",
            "estimated_mos"} <= set(got)
    for k, v in want.items():
        rtol = 1e-3 if k == "spectral_loss" else 1e-5
        atol = 1e-6 if k.endswith("stoi") else 1e-7
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)
    assert pt._gate_metric_name() == jt._gate_metric_name() \
        == "quality_score_audio"
    jt.close()
    pt.close()


# -- resume and checkpoints ---------------------------------------------------

def test_resume_equals_the_uninterrupted_run(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=2, save_every=2, ema_decay=0.5,
                      adversarial_warmup_steps=4)
    t1 = port(cfg)
    t1.train()
    assert t1.ckpt.all_steps() == [2]
    t2 = port(cfg)
    t2.train(resume=True)  # max_steps reached: restore, then exit
    assert (t2.step, t2.g_updates, t2.d_updates) == (2, 2, 2)
    _assert_equal(_state(t2), _state(t1))
    b1, b2 = _fixed_batch(t1), _fixed_batch(t2)
    m1, m2 = t1.train_step(b1), t2.train_step(b2)
    assert {k: v.item() for k, v in m1.items()} \
        == {k: v.item() for k, v in m2.items()}
    _assert_equal(_state(t2), _state(t1))
    t1.close()
    t2.close()


@pytest.mark.parametrize("keys_readable", [True, False],
                         ids=["keys_listed", "keys_unreadable"])
def test_pre_ema_checkpoint_resumes(tmp_path, caplog, keys_readable):
    cfg = tiny_config(tmp_path, max_steps=2, save_every=2)
    t1 = port(cfg)
    t1.train()
    t1.close()
    assert "generator_ema" not in t1.ckpt.state_keys()
    t2 = port(tiny_config(tmp_path, max_steps=2, save_every=2,
                          ema_decay=0.5))
    if not keys_readable:
        t2.ckpt.state_keys = lambda step=None: None
    with caplog.at_level(logging.WARNING):
        t2.restore()
    assert ("could not be read" if not keys_readable
            else "written with EMA off") in caplog.text
    for e, p in zip(t2.ema, t2.g_params):
        assert torch.equal(e, p)
    assert t2.step == 2
    t2.close()


def test_corrupt_checkpoint_raises(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=2, save_every=2, ema_decay=0.5)
    t1 = port(cfg)
    t1.train()
    t1.close()
    assert set(t1.ckpt.state_keys()) == {
        "generator", "g_opt_state", "discriminator", "d_opt_state", "step",
        "generator_ema"}
    (tmp_path / "out/ckpt/2/state.pt").write_bytes(b"not a checkpoint")
    t2 = port(cfg)
    assert t2.ckpt.state_keys() is None
    with pytest.raises(Exception):
        t2.restore()
    t2.close()


def test_best_pinned_and_served_with_the_ema(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=2, validate_every=2, ema_decay=0.5)
    t = port(cfg)
    t.train()
    t.close()
    ckpt = cfg["paths"]["checkpoint_dir"]
    best = json.loads((tmp_path / "out/ckpt/best/score.json").read_text())
    assert best["metric"] == "mel_loss" and best["step"] == 2
    state, _, _ = t._best_ckpt.restore()
    assert set(state) == {"generator", "g_opt_state", "discriminator",
                          "d_opt_state", "step", "generator_ema"}
    sd, _, step = load_for_inference(ckpt, step="best")
    ema = dict(zip(t.g_names, t.ema))
    assert step == 2 and all(torch.equal(sd[k], ema[k]) for k in ema)
    assert not all(torch.equal(state["generator"][k], ema[k]) for k in ema)
    served = pipeline.from_checkpoint(ckpt, step="best", device="cpu",
                                      **BUCKETS)
    ref = pipeline.Synthesizer(pipeline.build_model(Config(cfg).model),
                               device="cpu", **BUCKETS)
    ref.swap_params(ema)
    for a, b in zip(served.synthesize_batch(TEXTS, 3.0),
                    ref.synthesize_batch(TEXTS, 3.0)):
        assert a["frames"] == b["frames"] > 0
        np.testing.assert_array_equal(a["audio_pcm"], b["audio_pcm"])


def test_init_generator_from_a_stage1_checkpoint(tmp_path, caplog):
    s1 = tiny_config(tmp_path / "s1", max_steps=2, save_every=2,
                     validate_samples=False)
    t1 = Stage1Trainer(Config(s1), dataset=DummyDataset(**DS_KW),
                       device="cpu")
    t1.train()
    t1.close()
    cfg = tiny_config(tmp_path / "s2", ema_decay=0.5,
                      init_generator_from=s1["paths"]["checkpoint_dir"])
    with caplog.at_level(logging.INFO):
        t2 = port(cfg)
    assert "warm-started" in caplog.text
    trained = t1.model.state_dict()
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    for e, p in zip(t2.ema, t2.g_params):
        assert torch.equal(e, p)
    t2.close()


# -- guards ------------------------------------------------------------------

@pytest.mark.parametrize("where", ["before_update", "after_d_update"])
def test_oom_guard(tmp_path, where):
    t = port(tiny_config(tmp_path, max_steps=3))
    start = _state(t)
    calls = {"n": 0}
    name = ("_d_loss_and_grads" if where == "before_update"
            else "_g_loss_and_grads")
    real = getattr(t, name)

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("simulated OOM")
        return real(*args, **kw)

    setattr(t, name, flaky)
    batch = _fixed_batch(t)
    assert t._guarded_step(batch) is None and t.step == 0
    # after the D update the snapshot (the initial state) is restored
    _assert_equal(_state(t), start)
    assert (t.d_updates, t.g_updates) == (0, 0)
    last = t.train()
    t.close()
    assert t.step == 3 and np.isfinite(last["total_loss"])


def test_blowup_rewinds_and_is_bounded(tmp_path):
    t = port(tiny_config(tmp_path, max_steps=2, max_loss_blowups=1))
    t.train()
    assert t._oom_snapshot[1] == 2
    finite = _state(t)
    with torch.no_grad():
        for p in t.g_params:
            p.mul_(float("nan"))
    t.max_steps = 4
    last = t.train()
    assert t._blowups == 1 and t.step == 4 and np.isfinite(last["total_loss"])
    # over the limit: the snapshot is restored before the raise
    t._oom_snapshot = (t._oom_snapshot[0], 2, 2, 2)
    with torch.no_grad():
        for p in t.g_params:
            p.mul_(float("nan"))
    t.step = 9
    with pytest.raises(RuntimeError, match="non-finite"):
        t._recover_after_blowup()
    assert t.step == 2 and all(torch.isfinite(p).all() for p in t.g_params)
    t.close()
    assert finite  # the first rewind's snapshot was finite


def test_save_refuses_nonfinite_params(tmp_path):
    t = port(tiny_config(tmp_path, max_steps=2))
    t.train()  # the finally-save at step 2
    with torch.no_grad():
        t.d_params[0].mul_(float("nan"))
    t.step = 3
    t.save_checkpoint()
    assert t.ckpt.latest_step() == 2 and t._oom_snapshot[1] == 2
    t.close()


# -- data, options, CLI --------------------------------------------------------

def test_device_cache_windows(tmp_path):
    t = port(tiny_config(tmp_path, max_steps=3, device_data_cache=True))
    b = next(t._device_cached_iterator())
    assert b["audio"].shape[1] == b["mel"].shape[1] * t.upsample
    out = t._slice_batch(b, step=7)
    off = out["frame_offsets"].numpy()
    mel_len = b["mel_lengths"].numpy()
    assert (off >= 0).all() and (off <= np.maximum(mel_len - t.seg_frames,
                                                   0)).all()
    U, S = t.upsample, t.seg_frames
    for i in range(len(off)):
        np.testing.assert_array_equal(
            out["audio_seg"][i].numpy(),
            b["audio"][i, off[i] * U: off[i] * U + S * U].numpy())
    assert "audio" not in out
    again = t._slice_batch(b, step=7)["frame_offsets"]
    assert torch.equal(again, out["frame_offsets"])  # a function of step
    last = t.train()
    t.close()
    assert t.step == 3 and np.isfinite(last["discriminator_loss"])


@pytest.mark.parametrize("value,sn,resolved", [
    ("auto", False, "native"), ("native", False, "native"),
    ("packed", False, "packed"), ("packed", True, "native")])
def test_disc_lowering_parses(tmp_path, value, sn, resolved):
    t = port(tiny_config(tmp_path, disc_lowering=value,
                         discriminator_spectral_norm=sn))
    assert t.disc_lowering == resolved
    t.close()


def test_disc_lowering_packed_equals_native(tmp_path):
    """``_disc_apply`` through the packed lowering gives the module's
    logits and features on the same weights (JAX
    ``tests/test_train_stage2.py::test_disc_lowering_packed_equals_native``)."""
    t = port(tiny_config(tmp_path, disc_lowering="packed"))
    assert t.disc_lowering == "packed"
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 512, 1)).astype(np.float32))
    d_params = t._live(t.d_names, t.d_params, detach=True)
    lp, fp = t._disc_apply(d_params, audio)
    t.disc_lowering = "native"
    ln, fn = t._disc_apply(d_params, audio)
    t.close()
    for a, b in zip(ln, lp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert [len(f) for f in fp] == [len(f) for f in fn] == [6, 6, 6]
    for fa, fb in zip(fn, fp):
        for a, b in zip(fa, fb):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_disc_lowering_rejects_other_values(tmp_path):
    with pytest.raises(ValueError, match="disc_lowering"):
        port(tiny_config(tmp_path, disc_lowering="magic"))


@pytest.mark.parametrize("mesh", [{"data": 2}, {"data": -1, "model": 2}])
def test_mesh_beyond_one_device_raises(tmp_path, mesh):
    cfg = tiny_config(tmp_path)
    cfg["system"]["mesh"] = mesh
    # without a process group a mesh above one device names the launcher
    with pytest.raises(RuntimeError, match="torchrun"):
        port(cfg)


def test_alternate_gd_warns_that_the_adv_guard_is_inert(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        t = port(tiny_config(tmp_path, alternate_gd=True,
                             adaptive_adv_dloss_floor=0.15))
    assert caplog.text.count("no effect under training.alternate_gd") == 1
    t.close()
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        port(tiny_config(tmp_path / "b", alternate_gd=True)).close()
    assert "alternate_gd" not in caplog.text


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        cli_main(["training.max_steps=1"])


def test_cli_trains_two_steps(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    out = tmp_path / "cli"
    overrides = [
        "model.text_encoder.hidden_dim=32", "model.text_encoder.num_layers=1",
        "model.decoder.hidden_dim=32", "model.decoder.num_layers=1",
        "model.duration_predictor.hidden_dim=32",
        "model.vocoder.hidden_channels=32", "model.decoder.mel_channels=8",
        "data.n_mels=8", "data.buckets=[[32,64]]",
        f"data.data_dir={tmp_path / 'nodata'}",
        "training.batch_size=2", "training.max_steps=2",
        "training.audio_segment_len=2048", "training.log_every=1",
        "training.validate_every=100", "training.save_every=100",
        "training.bf16=false", f"paths.output_dir={out}",
        f"paths.checkpoint_dir={out / 'ckpt'}", f"paths.log_dir={out / 'logs'}"]
    proc = subprocess.run(
        [sys.executable, "-m", "m2tts_tpu_torch.training.train_stage2",
         "--device", "cpu", *overrides],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "using DummyDataset" in proc.stderr
    sd, cfg, step = load_for_inference(out / "ckpt")
    assert step == 2 and cfg.get("training.ema_decay") == 0.995
    assert cfg.get("training.learning_rate") == 2e-5  # the stage-2 recipe
    synth = pipeline.from_checkpoint(out / "ckpt", device="cpu", **BUCKETS)
    res = synth.synthesize_batch(TEXTS, 3.0)
    assert all(r["frames"] > 0 and np.isfinite(r["audio"]).all()
               for r in res)
