"""Stage-1 training of the PyTorch port (``training/trainer.py``,
``training/train.py``) against the JAX package's trainer, on the CPU at a
tiny size (1 layer, 32-d, 8 mel bins):

- the lr schedules equal optax's at every step (rtol 1e-6, atol 1e-7·lr:
  both compute in float32, and the f32 cosine may round apart by an ulp);
- the port's optimizer, fed the same gradients as ``make_optimizer``'s for
  6 calls, with accumulation k = 1 and 2 and the clip on and off: params
  and Adam moments within 1e-6;
- one f32 train step at dropout 0 (weights carried by ``from_flax``):
  losses and ``grad_norm`` rtol 1e-5, every gradient against ``jax.grad``
  of JAX's ``_loss_fn`` (atol 1e-6 + 1e-5·max|g|, rtol 1e-4); the params
  after 3 applied updates within ``PARAMS_ATOL``; in bf16 the losses and
  ``grad_norm`` within 1e-2 and the gradients within ``BF16_GRAD_REL_L2``;
- a JAX run carried into the port by ``optimizer_state_from_optax``
  continues as JAX does;
- accumulation, checkpoint and resume, dropout noise after a resume, the
  OOM and blow-up guards, non-finite saves, the ``best/`` pin served by
  ``from_checkpoint``, the device cache, the validator's WAVs, the mesh
  guard, and the CLI in a subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
from m2tts_tpu.data.dataset import make_batches as jax_make_batches
from m2tts_tpu.training import trainer as jtrainer
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.data.dataset import DummyDataset, data_iterator
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.training import trainer as ttrainer
from m2tts_tpu_torch.training.trainer import Stage1Trainer
from m2tts_tpu_torch.utils.checkpoint import load_for_inference
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax, optimizer_state_from_optax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0)
# the params after 3 applied updates (lr 1e-3): f32 within 1e-6 (measured
# 2.4e-7), bf16 within 1e-2 (measured 1.8e-3)
PARAMS_ATOL = {False: 1e-6, True: 1e-2}
# bf16 gradients as a whole: relative L2 distance from JAX's (measured
# 0.053; each bf16 rounding is 2^-8 relative, and they compound)
BF16_GRAD_REL_L2 = 0.1


def tiny_config(tmp_path, dropout=0.1, **training):
    t = {"batch_size": 8, "max_steps": 6, "learning_rate": 1e-3,
         "warmup_steps": 2, "gradient_clip_norm": 1.0, "bf16": False,
         "log_every": 2, "save_every": 100, "validate_every": 100,
         "max_checkpoints": 2, "seed": 0, "validate_samples": False}
    t.update(training)
    return {
        "model": {
            "text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                             "num_layers": 1, "num_heads": 2,
                             "dropout": dropout},
            "decoder": {"mel_channels": 8, "num_layers": 1},
            "vocoder": {"hidden_channels": 32},
        },
        "training": t,
        "data": {"buckets": [[48, 128]], "n_mels": 8},
        "system": {"mesh": {"data": -1}, "log_metrics": "jsonl"},
        "paths": {"output_dir": str(tmp_path / "out"),
                  "checkpoint_dir": str(tmp_path / "out/ckpt"),
                  "log_dir": str(tmp_path / "out/logs")},
    }


def port(cfg, **kw):
    return Stage1Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                         device="cpu", **kw)


def _sd(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def _assert_sd_close(a, b, **tol):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], msg=k, **tol)


# -- schedule and optimizer ------------------------------------------------

@pytest.mark.parametrize("sched", [
    {"lr_scheduler": "cosine", "warmup_steps": 7, "max_steps": 40},
    {"lr_scheduler": "cosine", "warmup_steps": 0, "max_steps": 25},
    {"lr_scheduler": "constant", "warmup_steps": 5, "max_steps": 20},
    {"lr_scheduler": "constant", "warmup_steps": 0, "max_steps": 10},
], ids=["cosine", "cosine_warmup0", "constant_warmup", "constant"])
def test_lr_schedule_matches_optax(sched):
    cfg = {"learning_rate": 3e-4, **sched}
    ours = ttrainer.make_lr_schedule(Config(cfg))
    ref = jtrainer.make_lr_schedule(JaxConfig(cfg))
    steps = range(cfg["max_steps"] + 3)
    np.testing.assert_allclose([ours(i) for i in steps],
                               [float(ref(i)) for i in steps],
                               rtol=1e-6, atol=1e-7 * cfg["learning_rate"])
    with pytest.raises(ValueError):
        ttrainer.make_lr_schedule(Config({"lr_scheduler": "bogus"}))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax(k, max_norm):
    cfg = {"learning_rate": 1e-2, "warmup_steps": 2, "max_steps": 10,
           "gradient_clip_norm": max_norm, "adam_b1": 0.8, "adam_b2": 0.99,
           "weight_decay": 1e-2, "gradient_accumulation_steps": k}
    rng = np.random.default_rng(0)
    shapes = {"w0": (3, 4), "w1": (5,), "w2": (2, 3, 2)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    tx = jtrainer.make_optimizer(JaxConfig(cfg))
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jstate = tx.init(jparams)
    module = torch.nn.ParameterDict(
        {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
         for n, a in params.items()})
    opt = ttrainer.Optimizer(Config(cfg), module.named_parameters())
    clipped = False
    for step in range(6):
        grads = {n: (rng.standard_normal(s) * 2).astype(np.float32)
                 for n, s in shapes.items()}
        clipped |= float(jax.numpy.sqrt(sum(
            (g ** 2).sum() for g in grads.values()))) >= max_norm
        updates, jstate = tx.update(
            jax.tree_util.tree_map(jax.numpy.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        opt.update([torch.from_numpy(grads[n]) for n in shapes])
        for n in shapes:
            np.testing.assert_allclose(module[n].detach().numpy(),
                                       np.asarray(jparams[n]), atol=1e-6,
                                       rtol=0, err_msg=f"{n} call {step}")
        want = optimizer_state_from_optax(jax.device_get(jstate), module)
        got = opt.state_dict()
        assert got["count"] == want["count"] == (step + 1) // k
        assert got["mini_step"] == want["mini_step"]
        for key in ("mu", "nu") + (("acc_grads",) if k > 1 else ()):
            assert set(got[key]) == set(want[key])
            for n in got[key]:
                np.testing.assert_allclose(got[key][n].numpy(),
                                           want[key][n].numpy(), atol=1e-6,
                                           rtol=0, err_msg=f"{key} {n}")
    assert clipped == (max_norm < 1)


# -- one step against JAX --------------------------------------------------

def _jax_and_port(tmp_path, **training):
    cfg = tiny_config(tmp_path, dropout=0.0, **training)
    jt = jtrainer.Stage1Trainer(
        JaxConfig(tiny_config(tmp_path / "jax", dropout=0.0, **training)),
        dataset=JaxDummyDataset(**DS_KW))
    pt = port(cfg)
    pt.model.load_state_dict(from_flax(jax.device_get(jt.state.params)))
    batches = list(jax_make_batches(JaxDummyDataset(**DS_KW), 8,
                                    jt.buckets, seed=5))
    return jt, pt, batches


def _grads_of_jax(jt, batch):
    def loss(p):
        return jt._loss_fn(p, jt._put(batch), jax.random.PRNGKey(0), True)

    (_, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jt.state.params)
    return (jax.device_get(losses), float(optax.global_norm(grads)),
            from_flax(jax.device_get(grads)))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_train_step_matches_jax(tmp_path, bf16):
    jt, pt, batches = _jax_and_port(tmp_path, bf16=bf16)
    rtol = 1e-2 if bf16 else 1e-5
    ref_losses, jnorm, ref_grads = _grads_of_jax(jt, batches[0])
    losses, grads = pt._forward_backward(pt._put(batches[0]))
    for k in ("mel_loss", "duration_loss", "total_loss"):
        np.testing.assert_allclose(losses[k].item(), float(ref_losses[k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(losses["grad_norm"].item(), jnorm, rtol=rtol)
    got = dict(zip(pt.param_names, grads))
    assert set(got) == set(ref_grads)
    if bf16:
        dist = sum(float(((g - ref_grads[n]) ** 2).sum())
                   for n, g in got.items())
        size = sum(float((g ** 2).sum()) for g in ref_grads.values())
        assert (dist / size) ** 0.5 < BF16_GRAD_REL_L2
    for name, g in got.items():
        ref = ref_grads[name]
        if not bf16:
            torch.testing.assert_close(
                g, ref, atol=1e-6 + 1e-5 * float(ref.abs().max()),
                rtol=1e-4, msg=name)
    # three applied updates (the first at lr 0 of the warmup)
    rng = jax.random.PRNGKey(0)
    state = jt.state
    for b in batches[:3]:
        state, jl = jt._train_step(state, jt._put(b), rng)
        tl = pt._train_step(pt._put(b))
        np.testing.assert_allclose(tl["total_loss"].item(),
                                   float(jl["total_loss"]), rtol=rtol)
    assert pt.optimizer.count == 3
    ref_params = from_flax(jax.device_get(state.params))
    _assert_sd_close(_sd(pt), ref_params, rtol=0, atol=PARAMS_ATOL[bf16])


@pytest.mark.parametrize("k,before", [(1, 2), (2, 3)],
                         ids=["k1", "k2_mid_accumulation"])
def test_jax_run_continues_in_the_port(tmp_path, k, before):
    jt, pt, batches = _jax_and_port(tmp_path, gradient_accumulation_steps=k,
                                    lr_scheduler="constant", warmup_steps=0)
    rng = jax.random.PRNGKey(0)
    state = jt.state
    for b in batches[:before]:
        state, _ = jt._train_step(state, jt._put(b), rng)
    host = jax.device_get(state)
    pt.model.load_state_dict(from_flax(host.params))
    pt.optimizer.load_state_dict(
        optimizer_state_from_optax(host.opt_state, pt.model))
    pt.step = int(host.step)
    assert pt.step == before and pt.optimizer.count == before // k
    state, jl = jt._train_step(state, jt._put(batches[before]), rng)
    tl = pt._train_step(pt._put(batches[before]))
    np.testing.assert_allclose(tl["total_loss"].item(),
                               float(jl["total_loss"]), rtol=1e-5)
    assert pt.optimizer.count == (before + 1) // k
    _assert_sd_close(_sd(pt), from_flax(jax.device_get(state.params)),
                     rtol=0, atol=1e-5)


# -- the trainer's own behaviour -------------------------------------------

def test_training_reduces_loss_and_defaults(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=20, log_every=1)
    t = port(cfg)
    assert t.model.training and t.transfer_dtype is None
    first = t.validate()["total_loss"]
    last = t.train()
    final = t.validate()["total_loss"]
    t.close()
    assert np.isfinite(last["total_loss"]) and final < first
    assert last["steps_per_sec"] > 0 and "host_rss_gb" in last
    rows = [json.loads(x) for x in
            (tmp_path / "out/logs/metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 21))


def test_gradient_accumulation_actually_accumulates(tmp_path):
    cfg = tiny_config(tmp_path, gradient_accumulation_steps=2,
                      lr_scheduler="constant", warmup_steps=0)
    t = port(cfg)
    it = data_iterator(t.dataset, 8, t.buckets, seed=0)
    p0 = _sd(t)
    t._train_step(t._put(next(it)))
    _assert_sd_close(_sd(t), p0, rtol=0, atol=0)  # nothing applied yet
    assert (t.optimizer.count, t.optimizer.mini_step) == (0, 1)
    t._train_step(t._put(next(it)))
    assert (t.optimizer.count, t.optimizer.mini_step) == (1, 0)
    assert any(not torch.equal(a, p0[k]) for k, a in _sd(t).items())
    assert all(float(a.abs().max()) == 0 for a in t.optimizer.acc)
    t.close()


def test_checkpoint_and_resume_restore_everything(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=4, save_every=2, validate_every=2,
                      gradient_accumulation_steps=3)
    t1 = port(cfg)
    t1.train()
    t1.close()
    assert t1.ckpt.all_steps() == [2, 4] and t1.step == 4
    best = json.loads((tmp_path / "out/ckpt/best/score.json").read_text())
    assert best["metric"] == "val_total_loss"

    t2 = port(cfg)
    t2.train(resume=True)  # max_steps reached: restore, then exit
    assert t2.step == 4 and t2.best_val_loss == pytest.approx(best["score"])
    _assert_sd_close(_sd(t2), _sd(t1), rtol=0, atol=0)
    s1, s2 = t1.optimizer.state_dict(), t2.optimizer.state_dict()
    assert (s2["count"], s2["mini_step"]) == (s1["count"], s1["mini_step"]) \
        == (1, 1)
    for key in ("mu", "nu", "acc_grads"):
        _assert_sd_close(s2[key], s1[key], rtol=0, atol=0)
    snap, snap_step = t2._oom_snapshot
    assert snap_step == 4
    _assert_sd_close(snap["params"], _sd(t1), rtol=0, atol=0)
    t2.close()

    t3 = port(tiny_config(tmp_path, max_steps=6, save_every=2,
                          gradient_accumulation_steps=3))
    t3.train(resume=True)
    assert t3.step == 6 and t3.optimizer.count == 2
    assert t3.ckpt.latest_step() == 6
    t3.close()


def test_best_score_of_another_metric_resets(tmp_path):
    ttrainer._write_best_score(tmp_path, 3, 0.5, metric="val_total_loss")
    assert ttrainer._read_best_score(tmp_path, 9.0, "val_total_loss") == 0.5
    assert ttrainer._read_best_score(tmp_path, 9.0, "val_quality") == 9.0
    (tmp_path / "best/score.json").write_text(json.dumps({"score": 0.1}))
    assert ttrainer._read_best_score(tmp_path, 9.0, "val_total_loss") == 9.0


def test_dropout_noise_is_a_function_of_the_step(tmp_path):
    cfg = tiny_config(tmp_path, dropout=0.3, max_steps=2, save_every=2)
    t1 = port(cfg)
    t1.train()
    t2 = port(cfg)
    t2.train(resume=True)
    batch = next(data_iterator(t1.dataset, 8, t1.buckets, seed=9))
    a, _ = t1._forward_backward(t1._put(batch))
    b, _ = t2._forward_backward(t2._put(batch))
    assert t1.step == t2.step == 2
    assert a["total_loss"].item() == b["total_loss"].item()  # same noise
    t2.step = 3
    c, _ = t2._forward_backward(t2._put(batch))
    t2.step, t2._blowups = 2, 1
    d, _ = t2._forward_backward(t2._put(batch))
    assert len({a["total_loss"].item(), c["total_loss"].item(),
                d["total_loss"].item()}) == 3
    t2.model.eval()  # dropout is the identity in eval mode
    x = torch.ones(4, 6)
    drop = t2.model.text_encoder.dropout
    assert torch.equal(drop(x), x)
    t1.close()
    t2.close()


@pytest.mark.parametrize("where", ["backward", "update"])
def test_oom_guard(tmp_path, where):
    t = port(tiny_config(tmp_path, max_steps=3, log_every=1))
    calls = {"n": 0}
    if where == "backward":
        real = t._forward_backward

        def flaky(batch):
            calls["n"] += 1
            if calls["n"] == 2:
                raise torch.cuda.OutOfMemoryError("simulated OOM")
            return real(batch)

        t._forward_backward = flaky
    else:
        real = t.optimizer.update

        def flaky(grads, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                with torch.no_grad():  # a half-written update
                    t.optimizer.params[0].add_(1e3)
                raise torch.cuda.OutOfMemoryError("simulated OOM")
            return real(grads, **kw)

        t.optimizer.update = flaky
    last = t.train()
    t.close()
    assert t.step == 3 and np.isfinite(last["total_loss"])
    # backward: the failed step is dropped (1 + 3 calls); update: the
    # snapshot of step 0 is restored and the loop replays (2 + 3 calls)
    assert calls["n"] == (4 if where == "backward" else 5)
    assert t.optimizer.count == 3
    emb = t.model.state_dict()[t.optimizer.names[0]]
    assert float(emb.abs().max()) < 100


def test_blowup_guard_rewinds_to_snapshot(tmp_path):
    t = port(tiny_config(tmp_path, max_steps=2, log_every=1))
    t.train()
    assert t.step == 2 and t._oom_snapshot[1] == 2
    with torch.no_grad():
        for p in t.model.parameters():
            p.mul_(float("nan"))
    t.max_steps = 4
    last = t.train()
    t.close()
    assert t._blowups == 1 and t.step == 4
    assert np.isfinite(last["total_loss"])


def test_blowup_guard_is_bounded(tmp_path):
    t = port(tiny_config(tmp_path, max_steps=2, log_every=1,
                         max_loss_blowups=0))
    with torch.no_grad():
        for p in t.model.parameters():
            p.mul_(float("nan"))
    t._oom_snapshot = (t._host_state_copy(), 0)  # the snapshot is bad too
    with pytest.raises(RuntimeError, match="non-finite"):
        t.train()
    t.close()


def test_blowup_over_limit_restores_before_raise(tmp_path):
    t = port(tiny_config(tmp_path, max_steps=2, log_every=1,
                         max_loss_blowups=0))
    finite = t._host_state_copy()
    t._oom_snapshot = (finite, 5)
    with torch.no_grad():
        for p in t.model.parameters():
            p.mul_(float("nan"))
    t.step = 9
    with pytest.raises(RuntimeError, match="non-finite"):
        t._recover_after_blowup()
    assert t.step == 5
    assert all(torch.isfinite(p).all() for p in t.model.parameters())
    t.close()


def test_save_checkpoint_refuses_nonfinite_params(tmp_path):
    t = port(tiny_config(tmp_path, max_steps=2, log_every=1))
    t.train()  # one good checkpoint at step 2 (the finally-save)
    with torch.no_grad():
        next(t.model.parameters()).mul_(float("nan"))
    t.step = 3
    t.save_checkpoint()
    assert t._oom_snapshot[1] == 2
    assert t.ckpt.latest_step() == 2
    t.close()


def test_best_checkpoint_pinned_and_served(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=4, validate_every=2)
    t = port(cfg)
    t.train()
    t.close()
    ckpt = cfg["paths"]["checkpoint_dir"]
    sd, config, step = load_for_inference(ckpt, step="best")
    assert step in (2, 4) and config.to_dict() == Config(cfg).to_dict()
    buckets = dict(text_buckets=(16,), frame_buckets=(64,),
                   batch_buckets=(2,))
    texts = ["hello world", "a test"]
    best = pipeline.from_checkpoint(ckpt, step="best", device="cpu",
                                    **buckets)
    ref = pipeline.Synthesizer(pipeline.build_model(config.model),
                               device="cpu", **buckets)
    ref.swap_params(sd)
    for a, b in zip(best.synthesize_batch(texts, 3.0),
                    ref.synthesize_batch(texts, 3.0)):
        assert a["frames"] == b["frames"] > 0
        np.testing.assert_array_equal(a["audio_pcm"], b["audio_pcm"])
    latest = pipeline.from_checkpoint(ckpt, device="cpu", **buckets)
    live = pipeline.Synthesizer(t.model, device="cpu", **buckets)
    for a, b in zip(latest.synthesize_batch(texts, 3.0),
                    live.synthesize_batch(texts, 3.0)):
        np.testing.assert_array_equal(a["audio_pcm"], b["audio_pcm"])


def test_device_cache_trains_and_falls_back(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=12, log_every=4,
                      device_data_cache=True, transfer_dtype="bfloat16")
    t = port(cfg)
    it = t._device_cached_iterator()
    first_batch = next(it)
    assert first_batch["mel"].dtype == torch.bfloat16
    first = t.validate()["total_loss"]
    last = t.train()
    assert np.isfinite(last["total_loss"])
    assert t.validate()["total_loss"] < first
    t.close()
    cfg["training"]["device_data_cache_max_gb"] = 1e-9
    t = port(cfg)
    assert t._device_cached_iterator() is None
    t.max_steps = 1
    t.train()  # streams instead
    t.close()


def test_validator_writes_wavs(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=2, validate_every=2,
                      validate_samples=True)
    cfg["system"].update(eval_texts=["Hello.", "Two texts."],
                         eval_text_bucket=16, eval_frame_bucket=64)
    t = port(cfg)
    t.train()
    t.close()
    wavs = sorted(p.name for p in (tmp_path / "out/samples").iterdir())
    assert wavs == ["sample_step_2_text_0.wav", "sample_step_2_text_1.wav"]
    logs = (tmp_path / "out/logs/metrics.jsonl").read_text()
    assert "val_estimated_mos" in logs and "val_sample_1_mos" in logs
    assert t.model.training  # the validator never touched the trainer's


def test_build_dataset_datafree_covers_all_buckets(tmp_path):
    cfg = Config({"data_dir": str(tmp_path / "nodata"), "n_mels": 8,
                  "buckets": [[64, 256], [128, 512], [256, 1000]]})
    ds = ttrainer.build_dataset(cfg)
    assert isinstance(ds, DummyDataset) and len(ds) == 256
    seen = set()
    it = data_iterator(ds, 4, [(64, 256), (128, 512), (256, 1000)], seed=0)
    for _ in range(64):
        b = next(it)
        seen.add((b["phoneme_ids"].shape[1], b["mel"].shape[1]))
        if len(seen) == 3:
            break
    assert len(seen) == 3


@pytest.mark.parametrize("mesh", [{"data": 2}, {"data": -1, "model": 2}])
def test_mesh_beyond_one_device_raises(tmp_path, mesh):
    cfg = tiny_config(tmp_path)
    cfg["system"]["mesh"] = mesh
    # without a process group a mesh above one device names the launcher
    with pytest.raises(RuntimeError, match="torchrun"):
        port(cfg)


def test_step_profiler_writes_a_trace(tmp_path):
    cfg = tiny_config(tmp_path, max_steps=5)
    cfg["system"]["profile"] = {"start_step": 2, "num_steps": 2,
                                "log_dir": str(tmp_path / "prof")}
    t = port(cfg)
    t.train()
    t.close()
    trace = tmp_path / "prof/trace_steps_2-3.json"
    assert t.profiler.trace_path == trace
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"train_step_2", "train_step_3"} <= names
    assert "train_step_4" not in names
    off = port(tiny_config(tmp_path / "off", max_steps=1))
    off.train()
    off.close()
    assert off.profiler.trace_path is None


def test_cli_trains_three_steps(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    out = tmp_path / "cli"
    overrides = [
        "model.text_encoder.hidden_dim=32", "model.text_encoder.num_layers=1",
        "model.decoder.hidden_dim=32", "model.decoder.num_layers=1",
        "model.duration_predictor.hidden_dim=32",
        "model.vocoder.hidden_channels=32", "model.decoder.mel_channels=8",
        "data.n_mels=8", "data.buckets=[[32,64]]",
        f"data.data_dir={tmp_path / 'nodata'}",
        "training.batch_size=2", "training.max_steps=3",
        "training.log_every=1", "training.validate_every=100",
        "training.save_every=100", "training.bf16=false",
        f"paths.output_dir={out}", f"paths.checkpoint_dir={out / 'ckpt'}",
        f"paths.log_dir={out / 'logs'}"]
    proc = subprocess.run(
        [sys.executable, "-m", "m2tts_tpu_torch.training.train",
         "--device", "cpu", *overrides],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "using DummyDataset" in proc.stderr
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["3"]
    sd, cfg, step = load_for_inference(out / "ckpt")
    assert step == 3 and cfg.get("model.text_encoder.hidden_dim") == 32
    assert cfg.get("training.learning_rate") == 8e-5  # the flagship's
