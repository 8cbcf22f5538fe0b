"""The graph paths of both trainers on the CPU (``utils/graphs.py``; no
graph is captured on the CPU, so these hold the host half each graph path
runs and the device half a graph would hold), at the tiny size of
``tests/test_torch_stage2_step.py`` (1 layer, 32-d, 8 mel bins, a 32-channel
vocoder, batch 8):

- the adversarial warmup ramp, a 0-d f32 device tensor the host fills,
  over five fused steps with ``adversarial_warmup_steps`` 3 (ramp 0, 1/3,
  2/3, 1, 1) through the graph path, with spectral norm: every logged
  loss within 1e-5 relative of JAX's ``Stage2Trainer``, and the ramp
  JAX's f32 value;
- D's fake and G's forward drawing the same dropout masks from their two
  generators (dropout 0.1): the two generator outputs of a fused step
  equal, and not equal to an eval-mode forward;
- which paths are graphs: ``step_graphs`` is a runner on CUDA, without a
  mesh or on an NCCL mesh (``parallel.mesh.is_nccl``, stood in for here;
  the gloo world of ``tests/test_torch_serving_mesh.py`` calls the real
  one), and None on the CPU and on a gloo mesh; ``_graphed()`` is false on
  the CPU and under
  ``disable_graphs()``, and, with a runner that is active as a CUDA one
  would be, true under accumulation and ``alternate_gd``;
- through such a runner (``EagerRunner``: it runs the function on copies
  of its inputs, as a graph reads its own input buffers), the keys each
  path asks for (fused, D, G; host and device-cached batches; each
  optimizer's branch under k = 2; validation's forward with the weights
  among its inputs; stage 1's step under k = 2 and its eval step) and
  results bitwise equal to the eager path's; an optimizer state load
  dropping the graphs, and an OOM in a graph call restoring the snapshot;
- the accumulation divisor, a 0-d device tensor the host fills, at k = 3
  over six micro-steps against optax's ``MultiSteps`` (1e-6, the
  optimizer bars of ``tests/test_torch_graphs.py``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
from m2tts_tpu.data.dataset import data_iterator as jax_data_iterator
from m2tts_tpu.training import trainer as jtrainer
from m2tts_tpu.training import trainer_stage2 as jstage2
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.data.dataset import DummyDataset, make_batches
from m2tts_tpu_torch.training import trainer as ttrainer
from m2tts_tpu_torch.training import trainer_stage2 as tstage2
from m2tts_tpu_torch.utils import graphs
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0, keep_audio=True)
LOSS_RTOL = 1e-5


def tiny_config(tmp_path, dropout=0.0, **training):
    t = {"batch_size": 8, "max_steps": 3, "learning_rate": 1e-3,
         "warmup_steps": 0, "lr_scheduler": "constant",
         "gradient_clip_norm": 1.0, "bf16": False, "audio_segment_len": 512,
         "log_every": 1, "save_every": 100, "validate_every": 100,
         "seed": 0, "stft_phase_weight": 0.0, "validate_samples": False,
         "validate_quality": False}
    t.update(training)
    return {
        "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                                   "num_layers": 1, "num_heads": 2,
                                   "dropout": dropout},
                  "decoder": {"mel_channels": 8, "num_layers": 1},
                  "vocoder": {"hidden_channels": 32}},
        "training": t,
        "data": {"buckets": [[48, 128]], "n_mels": 8, "hop_length": 256},
        "system": {"mesh": {"data": -1}, "log_metrics": "jsonl"},
        "paths": {"output_dir": str(tmp_path / "out"),
                  "checkpoint_dir": str(tmp_path / "out/ckpt"),
                  "log_dir": str(tmp_path / "out/logs")},
    }


class EagerRunner:
    """Stands in for a CUDA ``GraphRunner`` on the CPU: active outside
    ``disable_graphs()``, it runs ``fn`` on copies of its inputs (a graph
    reads its own input buffers) and records each call's key and
    generators."""

    def __init__(self):
        self.calls = []
        self.drops = 0

    def active(self) -> bool:
        return graphs.graphs_enabled()

    def drop(self) -> None:
        self.drops += 1

    def __call__(self, key, fn, *args, generators=()):
        self.calls.append((key, tuple(generators)))
        return fn(*(a.clone() for a in args))


def _stage2(tmp_path, dropout=0.0, **training):
    return tstage2.Stage2Trainer(Config(tiny_config(tmp_path, dropout,
                                                    **training)),
                                 dataset=DummyDataset(**DS_KW), device="cpu")


def _twin(tmp_path, t, **training):
    """A second port trainer on ``t``'s weights with the same config."""
    u = _stage2(tmp_path, **training)
    u.model.load_state_dict(t.model.state_dict())
    u.discriminator.load_state_dict(t.discriminator.state_dict())
    if u.ema is not None:
        with torch.no_grad():
            for e, p in zip(u.ema, t.ema):
                e.copy_(p)
    return u


def _host_batches(t, n):
    batches = list(itertools.islice(make_batches(
        t.dataset, 8, t.buckets, seed=0,
        audio_samples=t._max_audio_samples()), n))
    return batches


def _state(t):
    out = {f"g.{k}": v.clone() for k, v in t.model.state_dict().items()}
    out.update({f"d.{k}": v.clone()
                for k, v in t.discriminator.state_dict().items()})
    if t.ema is not None:
        out.update({f"ema.{n}": e.clone() for n, e in zip(t.g_names, t.ema)})
    for net, opt in (("g", t.g_opt), ("d", t.d_opt)):
        sd = opt.state_dict()
        for m in ("mu", "nu"):
            out.update({f"{net}.{m}.{k}": v.clone()
                        for k, v in sd[m].items()})
        if sd["acc_grads"]:
            out.update({f"{net}.acc.{k}": v.clone()
                        for k, v in sd["acc_grads"].items()})
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the ramp against JAX -----------------------------------------------------

def test_ramp_tensor_matches_jax_past_warmup(tmp_path):
    # spectral norm, as test_torch_stage2_step.py's f32 steps: without it
    # the steps after the first are ill-conditioned at lr 1e-3
    # (test_lowerings_at_lr_1e3)
    cfg = tiny_config(tmp_path, adversarial_warmup_steps=3,
                      discriminator_spectral_norm=True)
    jt = jstage2.Stage2Trainer(JaxConfig(cfg),
                               dataset=JaxDummyDataset(**DS_KW))
    pt = tstage2.Stage2Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                               device="cpu")
    pt.model.load_state_dict(from_flax(jax.device_get(jt.g_state.params)))
    pt.discriminator.load_state_dict(
        from_flax(jax.device_get(jt.d_state.params)))
    pt._graphs = EagerRunner()  # through the graph path's host half
    batches = list(itertools.islice(jax_data_iterator(
        JaxDummyDataset(**DS_KW), 8, jt.buckets, seed=0,
        audio_samples=jt._max_audio_samples()), 5))
    for i, b in enumerate(batches):
        mj = {k: float(v) for k, v in jt.train_step(b).items()}
        mp = {k: v.item() for k, v in pt.train_step(b).items()}
        ramp = np.clip(np.float32(i) / np.float32(3), 0, 1)
        assert pt._ramp.dtype == torch.float32 and pt._ramp.dim() == 0
        assert pt._ramp.item() == float(ramp), i
        assert set(mp) == set(mj)
        for k, v in mj.items():
            np.testing.assert_allclose(mp[k], v, rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
    assert [c[0][2:] for c in pt._graphs.calls] == [(True, True)] * 5
    jt.close()
    pt.close()


# -- the two dropout generators ------------------------------------------------

@pytest.mark.parametrize("via", ["eager", "graph_path"])
def test_d_fake_and_g_forward_draw_the_same_masks(tmp_path, via):
    t = _stage2(tmp_path, dropout=0.1)
    assert t._noise_d is not t._noise_g and len(t._dropouts) > 0
    if via == "graph_path":
        t._graphs = EagerRunner()
    audio, inputs = [], []
    fwd = t._acoustic_and_segment

    def record(g_params, batch, *a, **k):
        out = fwd(g_params, batch, *a, **k)
        audio.append(out[2].detach().clone())
        inputs.append(({n: p.detach().clone() for n, p in g_params.items()},
                       batch))
        return out

    t._acoustic_and_segment = record
    for b in _host_batches(t, 2):
        t.train_step(b)
    assert len(audio) == 4
    for i in range(2):  # D's fake (no grad), then G's forward
        assert torch.equal(audio[2 * i], audio[2 * i + 1]), i
    # the masks are live: the same forward in eval mode differs
    with torch.no_grad():
        t.model.eval()
        try:
            plain = fwd(*inputs[3])[2]
        finally:
            t.model.train()
    assert plain.shape == audio[3].shape
    assert not torch.equal(plain, audio[3])
    if via == "graph_path":
        gens = t._graphs.calls[0][1]
        assert gens == (t._noise_d, t._noise_g)
    t.close()


# -- which paths are graphs --------------------------------------------------

def test_graphs_only_on_cuda_without_a_mesh(tmp_path, monkeypatch):
    from types import SimpleNamespace

    from m2tts_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "is_nccl", lambda m: m.backend == "nccl")
    gloo, nccl = (SimpleNamespace(backend=b) for b in ("gloo", "nccl"))
    assert graphs.step_graphs("cpu", None) is None
    assert graphs.step_graphs("cpu", nccl) is None
    assert graphs.step_graphs("cuda", gloo) is None
    for mesh in (None, nccl):
        runner = graphs.step_graphs("cuda", mesh)
        assert isinstance(runner, graphs.GraphRunner)
        assert runner.device.type == "cuda"
    for kw in ({}, {"gradient_accumulation_steps": 2},
               {"alternate_gd": True}):
        t = _stage2(tmp_path, **kw)
        assert t._graphs is None and not t._graphed()  # the CPU
        assert not t.g_opt.capturable and not t.d_opt.capturable
        t._graphs = EagerRunner()  # active, as on CUDA
        assert t._graphed()
        with graphs.disable_graphs():
            assert not t._graphed()
        t.close()
    s1 = ttrainer.Stage1Trainer(
        Config(_stage1_config(tmp_path, k=2)),
        dataset=DummyDataset(**{**DS_KW, "keep_audio": False}), device="cpu")
    assert s1._graphs is None and not s1._graphed()
    s1._graphs = EagerRunner()
    assert s1._graphed()  # under accumulation too
    with graphs.disable_graphs():
        assert not s1._graphed()
    s1.close()


@pytest.mark.parametrize("kw,cached,keys", [
    ({}, False, [(True, True)] * 4),
    ({}, True, [(True, True)] * 4),
    ({"alternate_gd": True, "gradient_accumulation_steps": 2}, False,
     [(False, None), (None, False), (True, None), (None, True)]),
    ({"gradient_accumulation_steps": 2, "ema_decay": 0.5,
      "adaptive_d_lr_floor": 2.0, "adaptive_adv_dloss_floor": 2.0,
      "adversarial_warmup_steps": 2}, True,
     [(False, False), (True, True)] * 2),
], ids=["fused", "fused_cached", "alternate_k2", "k2_cached_ema_guards"])
def test_graph_path_equals_eager(tmp_path, kw, cached, keys):
    eager = _stage2(tmp_path / "eager", device_data_cache=cached, **kw)
    graph = _twin(tmp_path / "graph", eager, device_data_cache=cached, **kw)
    graph._graphs = EagerRunner()
    if cached:
        batches = list(itertools.islice(eager._device_cached_iterator(), 4))
    else:
        batches = _host_batches(eager, 4)
    for b in batches:
        me = eager.train_step(dict(b))
        mg = graph.train_step(dict(b))
        assert set(me) == set(mg)
        for k in me:
            assert torch.equal(me[k], mg[k]), k
    _assert_same(_state(eager), _state(graph))
    for a in ("step", "g_updates", "d_updates"):
        assert getattr(eager, a) == getattr(graph, a)
    for o in ("g_opt", "d_opt"):
        eo, go = getattr(eager, o), getattr(graph, o)
        assert (eo.count, eo.mini_step) == (go.count, go.mini_step)
    calls = graph._graphs.calls
    assert [c[0][2:] for c in calls] == keys
    for key, gens in calls:
        assert key[0] == "step" and ("audio" in key[1]) == cached
        assert gens == ((graph._noise_d, graph._noise_g)
                        + ((graph._offsets,) if cached else ()))
    eager.close()
    graph.close()


def test_state_loads_drop_the_graphs(tmp_path):
    t = _stage2(tmp_path)
    t._graphs = runner = EagerRunner()
    b = _host_batches(t, 1)[0]
    t.train_step(dict(b))
    assert runner.drops == 0
    t._restore_snapshot(t._snapshot())  # a rewind's restore
    t.train_step(dict(b))
    assert runner.drops == 1
    t.train_step(dict(b))
    assert runner.drops == 1
    t.close()


def test_oom_in_a_graph_call_restores_the_snapshot(tmp_path):
    """An OOM in a graph call can only be a bucket's first (its eager run
    or its capture; a replay allocates nothing), which may have written
    any tensor: the snapshot comes back even before any update began."""
    t = _stage2(tmp_path)
    t._graphs = EagerRunner()
    start = _state(t)
    b = _host_batches(t, 1)[0]
    real = t._d_loss_and_grads
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("simulated OOM")
        return real(*args, **kw)

    t._d_loss_and_grads = flaky
    with torch.no_grad():  # a write the restore must undo
        t.d_params[0].add_(1.0)
    assert t._guarded_step(dict(b)) is None
    _assert_same(_state(t), start)
    assert (t.step, t.d_updates, t.g_updates) == (0, 0, 0)
    assert (t.d_opt.count, t.g_opt.count) == (0, 0)
    assert t._guarded_step(dict(b)) is not None and t.step == 1
    t.close()


def test_validation_forward_takes_the_weights_as_inputs(tmp_path):
    t = _stage2(tmp_path, ema_decay=0.5)
    t._graphs = runner = EagerRunner()
    b = _host_batches(t, 1)[0]
    host = t._transfer.transfer(t._prepare(b, rng=np.random.default_rng(3)))
    t.train_step(dict(b))
    params = t._eval_params()
    got = t._val_fwd(host, params)
    with graphs.disable_graphs():
        want = t._val_fwd(host, params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    key, _ = runner.calls[-1]
    assert key[0] == "val" and key[2] == tuple(params)
    # the scored weights reach the forward as inputs: other weights, other
    # audio, from the same key
    other = {n: p + 0.01 for n, p in params.items()}
    moved = t._val_fwd(host, other)
    assert runner.calls[-1][0] == key
    assert not torch.equal(moved[3], got[3])
    t.close()


# -- stage 1 under accumulation, and its eval step -----------------------------

def _stage1_config(tmp_path, k):
    cfg = tiny_config(tmp_path, gradient_accumulation_steps=k,
                      dropout=0.1)
    cfg["training"]["validate_samples"] = False
    return cfg


def test_stage1_graph_path_equals_eager(tmp_path):
    ds = DummyDataset(**{**DS_KW, "keep_audio": False})
    tr = {}
    for mode in ("eager", "graph"):
        tr[mode] = ttrainer.Stage1Trainer(
            Config(_stage1_config(tmp_path / mode, k=2)), dataset=ds,
            device="cpu")
    tr["graph"].model.load_state_dict(tr["eager"].model.state_dict())
    tr["graph"]._graphs = runner = EagerRunner()
    batches = list(make_batches(ds, 8, tr["eager"].buckets, seed=5))[:4]
    for b in batches:
        for t in tr.values():
            losses = t._guarded_step(t._put(b))
            t.step += 1
        want = tr["eager"]._eval_step(tr["eager"]._put(b))
        got = tr["graph"]._eval_step(tr["graph"]._put(b))
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert losses is not None
    assert [c[0] for c in runner.calls] == [
        ("step", False), ("eval",), ("step", True), ("eval",)] * 2
    assert all(c[1] == (tr["graph"]._noise,) for c in runner.calls[::2])
    for k, v in tr["eager"].model.state_dict().items():
        assert torch.equal(tr["graph"].model.state_dict()[k], v), k
    eo, go = tr["eager"].optimizer, tr["graph"].optimizer
    assert (eo.count, eo.mini_step) == (go.count, go.mini_step) == (2, 0)
    for t in tr.values():
        t.close()


def test_accumulation_divisor_is_a_device_tensor_k3():
    cfg = {"learning_rate": 1e-2, "warmup_steps": 0, "max_steps": 8,
           "lr_scheduler": "constant", "gradient_clip_norm": 2.5,
           "adam_b1": 0.8, "adam_b2": 0.99, "weight_decay": 1e-2,
           "gradient_accumulation_steps": 3}
    rng = np.random.default_rng(2)
    shapes = {"w0": (3, 4), "w1": (5,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    tx = jtrainer.make_optimizer(JaxConfig(cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tx_update = jax.jit(tx.update)
    module = torch.nn.ParameterDict(
        {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
         for n, a in params.items()})
    opt = ttrainer.Optimizer(Config(cfg), module.named_parameters())
    divisors = []
    for step in range(6):
        grads = {n: rng.standard_normal(s).astype(np.float32)
                 for n, s in shapes.items()}
        updates, jstate = tx_update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        applies = opt.begin_update()
        assert isinstance(opt.divisor, torch.Tensor)
        assert opt.divisor.dim() == 0 and opt.divisor.dtype == torch.float32
        divisors.append(opt.divisor.item())
        assert applies == (step % 3 == 2)
        opt.device_update([torch.from_numpy(grads[n]) for n in shapes],
                          applies)
        opt.end_update(applies)
        for n in shapes:
            np.testing.assert_allclose(module[n].detach().numpy(),
                                       np.asarray(jparams[n]), atol=1e-6,
                                       rtol=0, err_msg=f"{n} step {step}")
    assert divisors == [1.0, 2.0, 3.0] * 2
    assert (opt.count, opt.mini_step) == (2, 0)
