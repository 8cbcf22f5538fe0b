"""The port's one-graph-per-bucket paths on the CPU (``utils/graphs.py``;
on the CPU no graph is captured, so these hold the code a graph captures)
against the JAX package, at a tiny size:

- the Synthesizer, whose duration scale is now a tensor input and whose
  batch goes through a staging tensor: at three duration scales (0.8, 1.0
  and 1.3 of one base scale) and two text sets, all in one frame bucket,
  the chosen bucket and every ``frames`` exact and int16 PCM within ±1
  LSB of JAX's ``Synthesizer``;
- ``synthesize_stream`` over three same-bucket batches equal to three
  separate calls, and ``swap_params`` equal to a fresh Synthesizer of the
  new weights; the swap writes in place (every tensor a graph reads, the
  model's, the bf16 copy's and the packed vocoder weights', keeps its
  storage) in f32 and bf16, its f32 PCM within ±1 LSB of JAX's
  ``swap_params``; the kernels' operands refreshed in place equal ones
  built from the new weights;
- the stage-1 optimizer with the one global norm the step computes passed
  to the clip, 5 steps against optax's ``make_optimizer`` (warmup-cosine
  lr, the clip active on at least one step): params and moments within
  1e-6, the stage-1 optimizer bars;
- the runner itself on the CPU (eager, arguments moved to its device),
  ``disable_graphs`` nesting, the collector paused during captures, the
  launch-counter bookkeeping a replay does, and the trainer's and streamers' use of it (the short path under
  a key of its own, one entry per length).

The CUDA cases of the same checks (replay against ``disable_graphs()``,
a failed capture that raises) are in ``tests/test_torch_cuda.py``.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import M2TTS as JaxM2TTS
from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer
from m2tts_tpu.training import trainer as jtrainer
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.models.tts_model import M2TTS, init_params
from m2tts_tpu_torch.serving.pipeline import Synthesizer
from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer
from m2tts_tpu_torch.training import trainer as ttrainer
from m2tts_tpu_torch.utils import graphs
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import from_flax, optimizer_state_from_optax

torch.set_num_threads(2)

KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(128, 256),
               batch_buckets=(1, 2, 4))
TEXT_SETS = (["hello world", "the quick brown fox", "a"],
             ["one more text", "brown fox jumps", "hello there"])
BASE = 6.0  # random-init durations are ~0.3 frames; scale them up
SCALES = (0.8 * BASE, BASE, 1.3 * BASE)


@lru_cache(maxsize=None)
def _flax_params(seed):
    model = JaxM2TTS(**KW)
    params = jax.device_get(jax.jit(partial(
        model.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    return model, params


def _port_model(params):
    tm = M2TTS(**KW)
    tm.load_state_dict(from_flax(params), strict=True)
    return tm


@pytest.fixture(scope="module")
def pair():
    jm, params = _flax_params(0)
    return (JaxSynthesizer(jm, params, **BUCKETS),
            Synthesizer(_port_model(params), device="cpu", **BUCKETS))


def _assert_pcm_close(a, b):
    assert a.shape == b.shape
    if a.size:
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("scale", SCALES, ids=["0.8", "1.0", "1.3"])
@pytest.mark.parametrize("texts", TEXT_SETS, ids=["set0", "set1"])
def test_scales_and_text_sets_match_jax(pair, texts, scale):
    js, ts = pair
    j_out, j_frames = js._launch(texts, scale, None, False)
    t_out, t_frames = ts._launch(texts, scale, None, False)
    assert j_frames == t_frames == 128  # one frame bucket for all six
    ref = js._collect(j_out, j_frames, len(texts), False)
    out = ts._collect(t_out, t_frames, len(texts), False)
    for r, o in zip(ref, out):
        assert r["frames"] == o["frames"]
        assert not o.get("truncated")
        _assert_pcm_close(r["audio_pcm"], o["audio_pcm"])


def test_the_scale_reaches_the_device_as_a_tensor(pair):
    _, ts = pair
    scale = ts._scale(1.3)
    assert scale.dtype == torch.float32 and scale.dim() == 0
    packed = ts._to_device(np.zeros((2, 5), np.int32))
    assert packed.shape == (2, 5) and packed.dtype == torch.int32
    frames = [ts.predict_frames(np.ones((1, 4), np.int32), np.array([4]),
                                s)[0] for s in SCALES]
    assert frames == sorted(frames) and frames[0] < frames[-1]


def test_synthesize_stream_equals_separate_calls(pair):
    _, ts = pair
    batches = [TEXT_SETS[0], TEXT_SETS[1], TEXT_SETS[0][::-1]]
    streamed = list(ts.synthesize_stream(iter(batches), BASE))
    assert len(streamed) == 3
    for got, texts in zip(streamed, batches):
        for g, w in zip(got, ts.synthesize_batch(texts, BASE)):
            assert g["frames"] == w["frames"]
            np.testing.assert_array_equal(g["audio_pcm"], w["audio_pcm"])


def test_swap_params_equals_a_fresh_synthesizer():
    _, params0 = _flax_params(0)
    other = init_params(M2TTS(**KW), torch.Generator().manual_seed(1),
                        "cpu")
    ts = Synthesizer(_port_model(params0), device="cpu",
                     vocoder_backend="mm", **BUCKETS)
    before = ts.synthesize_batch(TEXT_SETS[0], BASE)
    ts.swap_params({k: v.clone() for k, v in other.state_dict().items()})
    fresh = Synthesizer(other, device="cpu", vocoder_backend="mm",
                        **BUCKETS)
    after = ts.synthesize_batch(TEXT_SETS[0], BASE)
    assert any(not np.array_equal(a["audio_pcm"], b["audio_pcm"])
               for a, b in zip(after, before))
    for a, f in zip(after, fresh.synthesize_batch(TEXT_SETS[0], BASE)):
        assert a["frames"] == f["frames"]
        np.testing.assert_array_equal(a["audio_pcm"], f["audio_pcm"])
    assert ts.graph_stats()["graphs"] == 0  # no graph on the CPU


def _nest(tree):
    """Every tensor of a nest of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _nest(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _nest(v)]
    return []


def _graph_storage(ts):
    """The data pointers of every tensor a Synthesizer's graphs read: the
    model's, its bf16 copy's and the packed vocoder weights'."""
    models = [ts.model] + ([ts._bf16_model] if ts._bf16_model else [])
    return ([t.data_ptr() for m in models for t in m.state_dict().values()]
            + [t.data_ptr() for t in _nest(ts._vocode.packed)])


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_swap_params_writes_in_place(cd):
    """After a first call (which packs the vocoder weights and makes the
    bf16 copy), a swap keeps every tensor's storage and serves what a fresh
    Synthesizer on the new weights serves; in f32 also what JAX's
    ``swap_params`` serves (±1 LSB)."""
    jm, params0 = _flax_params(0)
    _, params1 = _flax_params(1)
    kw = dict(device="cpu", vocoder_backend="mm", compute_dtype=cd,
              **BUCKETS)
    ts = Synthesizer(_port_model(params0), **kw)
    before = ts.synthesize_batch(TEXT_SETS[0], BASE)
    assert (ts._bf16_model is not None) == (cd == "bf16")
    storage = _graph_storage(ts)
    ts.swap_params(from_flax(params1))
    assert _graph_storage(ts) == storage
    after = ts.synthesize_batch(TEXT_SETS[0], BASE)
    assert any(not np.array_equal(a["audio_pcm"], b["audio_pcm"])
               for a, b in zip(after, before))
    fresh = Synthesizer(_port_model(params1), **kw)
    for a, f in zip(after, fresh.synthesize_batch(TEXT_SETS[0], BASE)):
        assert a["frames"] == f["frames"]
        np.testing.assert_array_equal(a["audio_pcm"], f["audio_pcm"])
    if cd == "f32":
        js = JaxSynthesizer(jm, params0, **BUCKETS)
        js.swap_params(params1)
        for a, j in zip(after, js.synthesize_batch(TEXT_SETS[0], BASE)):
            assert a["frames"] == j["frames"]
            _assert_pcm_close(a["audio_pcm"], j["audio_pcm"])


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_kernel_operands_refresh_in_place(cd):
    """``refresh_operands`` rewrites the tensor-core operands cached for a
    packed weight set (the chunk stream, offsets, biases, the output conv)
    from its new weights into the same tensors: equal to operands built
    afresh, at the same addresses."""
    from m2tts_tpu_torch.ops.cuda import vocoder as cuda_vocoder
    from m2tts_tpu_torch.ops.vocoder_mm import pack_vocoder_weights
    from m2tts_tpu_torch.serving.pipeline import _copy_into

    cpu = torch.device("cpu")
    m0, m1 = (_port_model(_flax_params(s)[1]) for s in (0, 1))
    packed = pack_vocoder_weights(m0.vocoder, cd)
    ops = cuda_vocoder._tc_operands(packed, KW["mel_channels"], cpu, cd)
    ptrs = [t.data_ptr() for _, o in ops for t in _nest(o)]
    streams = [o["w"].clone() for _, o in ops]
    _copy_into(packed, pack_vocoder_weights(m1.vocoder, cd))
    cuda_vocoder.refresh_operands(packed)
    assert [t.data_ptr() for _, o in ops for t in _nest(o)] == ptrs
    want = cuda_vocoder._tc_operands(pack_vocoder_weights(m1.vocoder, cd),
                                     KW["mel_channels"], cpu, cd)
    assert len(ops) == len(want)
    for (_, got), (_, new) in zip(ops, want):
        assert set(got) == set(new)
        for k, v in new.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), k
    assert not any(torch.equal(o["w"], w) for (_, o), w in zip(ops, streams))


def test_optimizer_with_one_global_norm_matches_optax():
    cfg = {"learning_rate": 1e-2, "warmup_steps": 2, "max_steps": 8,
           "lr_scheduler": "cosine", "gradient_clip_norm": 2.5,
           "adam_b1": 0.8, "adam_b2": 0.99, "weight_decay": 1e-2}
    rng = np.random.default_rng(1)
    shapes = {"w0": (3, 4), "w1": (5,), "w2": (2, 3, 2)}
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
    assert not opt.capturable
    clipped = []
    for step in range(5):
        # steps 1 and 3 above the clip, the others below it
        g_scale = 2.0 if step % 2 else 0.2
        grads = {n: (rng.standard_normal(s) * g_scale).astype(np.float32)
                 for n, s in shapes.items()}
        tg = [torch.from_numpy(grads[n]) for n in shapes]
        norm = ttrainer.global_norm(tg)  # the step's one global norm
        clipped.append(float(norm) >= cfg["gradient_clip_norm"])
        updates, jstate = tx_update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        opt.update(tg, norm=norm)
        for n in shapes:
            np.testing.assert_allclose(module[n].detach().numpy(),
                                       np.asarray(jparams[n]), atol=1e-6,
                                       rtol=0, err_msg=f"{n} step {step}")
        want = optimizer_state_from_optax(jax.device_get(jstate), module)
        got = opt.state_dict()
        assert got["count"] == want["count"] == step + 1
        for key in ("mu", "nu"):
            for n in got[key]:
                np.testing.assert_allclose(got[key][n].numpy(),
                                           want[key][n].numpy(), atol=1e-6,
                                           rtol=0, err_msg=f"{key} {n}")
    assert any(clipped) and not all(clipped)


def test_clip_takes_the_given_norm():
    opt = ttrainer.Optimizer(Config({"gradient_clip_norm": 1.0}),
                             [("w", torch.nn.Parameter(torch.zeros(3)))])
    g = [torch.tensor([3.0, 4.0, 0.0])]
    np.testing.assert_allclose(opt.clip(g)[0].numpy(), [0.6, 0.8, 0.0],
                               rtol=1e-6)
    # a norm passed in is the one the clip divides by
    np.testing.assert_allclose(
        opt.clip(g, torch.tensor(10.0))[0].numpy(), [0.3, 0.4, 0.0],
        rtol=1e-6)


def test_runner_runs_eagerly_on_the_cpu():
    runner = graphs.GraphRunner("cpu")
    assert not runner.active()
    calls = []

    def fn(x, y):
        calls.append(1)
        return {"sum": x + y, "pair": (x * 2, None)}

    x, y = torch.arange(3.0), torch.ones(3)
    for _ in range(2):
        out = runner(("k",), fn, x, y)
        torch.testing.assert_close(out["sum"], x + y)
        torch.testing.assert_close(out["pair"][0], x * 2)
        assert out["pair"][1] is None
    assert len(calls) == 2 and len(runner) == 0
    assert runner.stats()["graphs"] == 0


def test_disable_graphs_nests():
    assert graphs.graphs_enabled()
    with graphs.disable_graphs():
        assert not graphs.graphs_enabled()
        with graphs.disable_graphs():
            assert not graphs.graphs_enabled()
        assert not graphs.graphs_enabled()
    assert graphs.graphs_enabled()
    with pytest.raises(ValueError):
        with graphs.disable_graphs():
            raise ValueError("inside")
    assert graphs.graphs_enabled()


def test_gc_is_paused_while_capturing():
    """Python's cyclic collector stays off from the first capture's start
    to the last one's end (nested as captures in two threads would be),
    then returns to the state it had before."""
    import gc

    assert gc.isenabled()
    with graphs._gc_paused():
        assert not gc.isenabled()
        with graphs._gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with graphs._gc_paused():
            pass
        assert not gc.isenabled()  # off before, off after
    finally:
        gc.enable()


def test_a_replay_adds_its_captured_launches(monkeypatch):
    from m2tts_tpu_torch.ops.cuda import build
    from m2tts_tpu_torch.ops.cuda import vocoder as cuda_vocoder

    monkeypatch.setattr(cuda_vocoder, "LAUNCHES_TC", 5)
    monkeypatch.setattr(cuda_vocoder, "LAUNCHES_TC32", 1)
    monkeypatch.setattr(build, "PROBE_LAUNCHES", 0)
    before = graphs._counts()
    assert before == (5, 1, 0)
    graphs._add_counts((4, 0, 1))
    assert graphs._counts() == (9, 1, 1)
    graphs._add_counts([-4, 0, -1])  # what a capture takes back
    assert graphs._counts() == before


def test_tree_map_clones_nested_outputs():
    t = torch.zeros(2)
    out = graphs._tree_map(torch.Tensor.clone,
                           {"a": t, "b": [t, (t, 3)], "c": "x"})
    out["a"].add_(1)
    out["b"][0].add_(1)
    out["b"][1][0].add_(1)
    assert torch.equal(t, torch.zeros(2))
    assert out["b"][1][1] == 3 and out["c"] == "x"
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)


def test_trainer_and_streamers_stay_eager_on_the_cpu(tmp_path):
    from m2tts_tpu_torch.data.dataset import DummyDataset

    cfg = Config({
        "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 16,
                                   "num_layers": 1, "num_heads": 2},
                  "decoder": {"mel_channels": 8, "num_layers": 1},
                  "vocoder": {"hidden_channels": 16}},
        "training": {"batch_size": 4, "max_steps": 2, "bf16": False,
                     "validate_samples": False},
        "data": {"buckets": [[48, 128]], "n_mels": 8},
        "system": {"log_metrics": "jsonl"},
        "paths": {"output_dir": str(tmp_path / "out"),
                  "checkpoint_dir": str(tmp_path / "out/ckpt"),
                  "log_dir": str(tmp_path / "out/logs")}})
    t = ttrainer.Stage1Trainer(
        cfg, dataset=DummyDataset(size=8, mel_dim=8, max_text_length=40,
                                  max_mel_length=120, seed=0),
        device="cpu")
    assert t._graphs is None and not t._graphed()
    assert not t.optimizer.capturable
    loads = t.optimizer.loads
    t._restore(t._host_state_copy(), 0)
    assert t.optimizer.loads == loads + 1
    t.close()
    _, params = _flax_params(0)
    ss = StreamingSynthesizer(_port_model(params), chunk_frames=16,
                              max_frames=128, text_bucket=32, device="cpu")
    assert not ss.graphs.active() and not ss.vocoder.graphs.active()
    ids = torch.ones((1, 32), dtype=torch.int32)
    lengths = torch.tensor([12], dtype=torch.int32)
    with torch.inference_mode():
        mel, total = ss._acoustic(ids, lengths, BASE)
        mel2, total2, head = ss._acoustic_first_fn(
            ids, lengths, torch.tensor(BASE))
        chunk0 = ss.vocoder._run_chunk(mel[:, :ss.vocoder._window])
    torch.testing.assert_close(mel, mel2, rtol=0, atol=0)
    assert torch.equal(total, total2)
    n0 = ss.vocoder.chunk_frames * ss.vocoder.upsample
    torch.testing.assert_close(head[:n0], chunk0[0, :n0], rtol=0, atol=0)
    assert int(head[n0]) == int(total[0])


class _KeyRunner:
    """A stand-in for an active runner: records each call's key and
    shapes, and runs the function as a graph's first call does."""

    def __init__(self):
        self.keys = []

    def __call__(self, key, fn, *args, generators=()):
        self.keys.append((key, tuple(tuple(a.shape) for a in args)))
        return fn(*args)


def test_short_path_runs_under_a_key_per_length():
    """The streaming short path goes through the chunk graphs' runner under
    its own key, one graph a length (the runner keys by shape): what it
    returns there equals the whole mel vocoded in one call."""
    _, params = _flax_params(0)
    sv = StreamingSynthesizer(_port_model(params), chunk_frames=16,
                              max_frames=128, text_bucket=32,
                              device="cpu").vocoder
    sv.graphs = _KeyRunner()
    mel = torch.randn(3, sv._window, KW["mel_channels"],
                      generator=torch.Generator().manual_seed(2))
    lengths = (5, sv._window, 5, 11)
    with torch.inference_mode():
        for i, T in enumerate(lengths):
            got = np.concatenate(list(sv.stream(mel[i % 3, :T])))
            want = sv._full(mel[i % 3, :T][None])[0].numpy()
            np.testing.assert_array_equal(got, want)
    assert sv.graphs.keys == [(("short",), ((1, T, KW["mel_channels"]),))
                              for T in lengths]
