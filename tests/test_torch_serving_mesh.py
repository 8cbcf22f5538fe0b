"""Multi-device serving of the PyTorch port (``Synthesizer(mesh=...)``, the
server's ``--data-parallel``) against the JAX package's mesh
``Synthesizer``, on the CPU.

The cases of ``tests/test_serving_mesh.py``, on one world of two gloo ranks
spawned by ``parallel.mesh.spawn_world`` (the ranks import no JAX); the
parent runs the JAX Synthesizer on ``make_mesh(data=2)`` of the conftest's
virtual CPU devices, on the same weights (the port's, by ``to_flax``):

- a (2, 1) mesh gives the frames of the JAX mesh Synthesizer and of the
  port's single-device one, PCM within 1 LSB of both; so does a (1, 2)
  mesh (the TP rules at serve time) in f32; in bf16 its frame counts are
  held as ``tests/test_torch_serving.py`` holds bf16;
- batch buckets that do not divide by 'data' raise ``ValueError``;
  ``reachable_shapes`` holds only divisible batches;
- the server's ``--data-parallel 2`` builds buckets ``(2, 8, 32)``; its
  rank 0 leads (a batch, a weight swap, a batch, stop) and rank 1 follows,
  each answer equal to a single-device Synthesizer's; rank 0's HTTP server
  answers a ``/reload`` of another architecture with a 400, rank 1 outlives
  a call that fails on it alone, and the next request is served;
- the vocoder kernel's wrapper refuses a DTensor;
- a gloo mesh runs no graph (``step_graphs`` and the Synthesizer's runner
  are None; ``is_nccl`` is false);
- ``swap_params`` on a mesh writes the new weights into the local tensors,
  the bf16 copy and the packed vocoder weights in place (their storage
  kept) on (2, 1) in f32 and (1, 2) in bf16, and serves what a fresh mesh
  Synthesizer on the new weights serves (exactly), a single device's and,
  in f32, JAX's mesh ``swap_params`` (±1 LSB).
"""

import argparse

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate

from m2tts_tpu_torch.models.tts_model import M2TTS, init_params
from m2tts_tpu_torch.parallel import mesh as pmesh
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.serving.pipeline import Synthesizer

torch.set_num_threads(2)

TEXTS = ["hello world", "the quick brown fox", "speech synthesis",
         "a longer sentence for the last slot of the batch"]
KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
BUCKETS = dict(text_buckets=(32,), frame_buckets=(128,), batch_buckets=(4,))
SCALE = 12.0  # random-init durations are ~0.3 frames; scale them up


def weights(seed=0):
    return init_params(M2TTS(**KW), torch.Generator().manual_seed(seed),
                       "cpu").state_dict()


def _synth(mesh=None, seed=0, **kw):
    model = M2TTS(**KW)
    model.load_state_dict(weights(seed))
    return Synthesizer(model, device="cpu", mesh=mesh, **{**BUCKETS, **kw})


def _nest(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _nest(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _nest(v)]
    return []


def _graph_storage(s):
    """The data pointers of every tensor a Synthesizer's graphs read: the
    model's (local) tensors, its bf16 copy's, the packed vocoder
    weights'."""
    models = [s.model] + ([s._bf16_model] if s._bf16_model else [])
    return ([t.data_ptr() for m in models for t in m.state_dict().values()]
            + [t.data_ptr() for t in _nest(s._vocode.packed)])


def _swapped(mesh, compute_dtype):
    """A mesh Synthesizer (``mm``) that served seed 0's weights, swapped to
    seed 1's: (storage kept, its outputs, a fresh mesh Synthesizer's)."""
    s = _synth(mesh, vocoder_backend="mm", compute_dtype=compute_dtype)
    s.synthesize_batch(TEXTS, SCALE)
    storage = _graph_storage(s)
    s.swap_params(weights(1))
    fresh = _synth(mesh, seed=1, vocoder_backend="mm",
                   compute_dtype=compute_dtype)
    return (_graph_storage(s) == storage,
            _outputs(s.synthesize_batch(TEXTS, SCALE)),
            _outputs(fresh.synthesize_batch(TEXTS, SCALE)))


def _outputs(results):
    return [(r["frames"], r["audio_pcm"]) for r in results]


def _server_args():
    from m2tts_tpu_torch.serving.server import parse_args

    return parse_args(["--random-init", "--device", "cpu",
                       "--data-parallel", "2", "--compute-dtype", "f32"])


# -- what the ranks run (no JAX) --------------------------------------------

def _serving_world():
    from m2tts_tpu_torch.ops.cuda.vocoder import fused_vocoder_forward
    from m2tts_tpu_torch.ops.vocoder_mm import pack_vocoder_weights
    from m2tts_tpu_torch.serving.server import build_synthesizer

    rank = pmesh.dist.get_rank()
    res = {}
    dp = pmesh.make_mesh(2, 1, device_type="cpu")
    res["dp"] = _outputs(_synth(dp).synthesize_batch(TEXTS, SCALE))
    try:
        _synth(dp, batch_buckets=(1, 4))
    except ValueError as e:
        res["indivisible"] = str(e)
    res["shapes"] = _synth(dp, batch_buckets=(2, 4)).reachable_shapes(
        full=False)
    tp = pmesh.make_mesh(1, 2, device_type="cpu")
    res["tp"] = _outputs(_synth(tp).synthesize_batch(TEXTS[:2], SCALE))
    res["tp_bf16"] = _outputs(_synth(tp, compute_dtype="bf16")
                              .synthesize_batch(TEXTS[:2], SCALE))

    # a gloo mesh runs eagerly; weight swaps write in place
    from m2tts_tpu_torch.utils.graphs import step_graphs

    res["graphs"] = (pmesh.is_nccl(dp), step_graphs("cuda", dp),
                     step_graphs("cpu", dp), _synth(dp)._graphs)
    res["swap"] = {"dp_f32": _swapped(dp, "f32"),
                   "tp_bf16": _swapped(tp, "bf16")}

    # a DTensor never reaches the kernel's pointers
    packed = pack_vocoder_weights(_synth().model.vocoder, "f32")
    mel = DTensor.from_local(torch.zeros(1, 4, 16), tp["model"],
                             [Replicate()], run_check=False)
    try:
        fused_vocoder_forward(mel, packed, KW_RATES, "f32")
    except TypeError as e:
        res["dtensor"] = str(e)

    # the server's data-parallel Synthesizer: rank 0 leads, rank 1 follows
    synth = build_synthesizer(_server_args())
    res["buckets"] = synth.batch_buckets
    swap = pipeline.from_config({"model": synth.config.get("model")},
                                seed=1, device="cpu").model.state_dict()
    if rank == 0:
        synth.lead()
        res["led"] = [_outputs(synth.synthesize_batch(["hello world"], 4.0))]
        synth.swap_params(swap)
        res["led"].append(_outputs(synth.synthesize_batch_long(
            ["hello world. the quick brown fox"], 4.0)))
        res["http"] = _bad_reload_then_request(synth)
        synth.stop_followers()
    else:
        synth.serve_followers()
        res["followed"] = True
    return res


def _bad_reload_then_request(synth):
    """On the leader: its HTTP server's ``/reload`` of a checkpoint of
    another architecture (a 400, checked before the followers hear of it),
    a swap that fails on the follower alone (sent past the leader's
    checks), then one ``/synthesize``: (the reload's status and error, the
    request's status and PCM)."""
    import io
    import json
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    import wave
    from http.server import ThreadingHTTPServer

    from m2tts_tpu_torch.serving import server as tserver
    from m2tts_tpu_torch.utils.checkpoint import CheckpointManager

    def post(route, obj):
        req = urllib.request.Request(
            url + route, data=json.dumps(obj).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserver.make_handler(
        synth, tserver.device_info(synth)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            CheckpointManager(tmp).save(1, {"generator": weights()},
                                        config={"model": {}})
            reload_status, body = post("/reload", {"checkpoint": tmp})
        reload_error = json.loads(body)["error"]
        bad = dict(synth.model.state_dict())
        bad.popitem()
        synth._announce("swap_params", bad)
        status, wav = post("/synthesize", {"text": "hello world",
                                           "duration_scale": 4.0})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
    with wave.open(io.BytesIO(wav)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return reload_status, reload_error, status, pcm


KW_RATES = (4, 4, 2, 2)  # M2TTS's default upsample rates


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return pmesh.spawn_world(_serving_world, 2,
                             workdir=str(tmp_path_factory.mktemp("serving")))


@pytest.fixture(scope="module")
def jax_mesh_outputs():
    import jax

    from m2tts_tpu.models import M2TTS as JaxM2TTS
    from m2tts_tpu.parallel.mesh import make_mesh
    from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer
    from m2tts_tpu_torch.utils.params import to_flax

    params = jax.tree_util.tree_map(np.asarray, to_flax(weights()))
    js = JaxSynthesizer(JaxM2TTS(**KW), params, **BUCKETS,
                        mesh=make_mesh(data=2, devices=jax.devices()[:2]))
    return _outputs(js.synthesize_batch(TEXTS, SCALE))


def _assert_same(got, want, lsb=1):
    assert len(got) == len(want)
    for (fa, pa), (fb, pb) in zip(got, want):
        assert fa == fb > 0
        assert pa.shape == pb.shape
        assert np.abs(pa.astype(np.int32) - pb).max() <= lsb


def test_mesh_serving_matches_single_device(world, jax_mesh_outputs):
    single = _outputs(_synth().synthesize_batch(TEXTS, SCALE))
    for rank in world:
        _assert_same(rank["dp"], jax_mesh_outputs)
        _assert_same(rank["dp"], single)


def test_mesh_serving_with_model_axis(world, jax_mesh_outputs):
    """(1, 2): the TP rules at serve time; every rank returns the whole
    batch."""
    single = _outputs(_synth().synthesize_batch(TEXTS[:2], SCALE))
    for rank in world:
        _assert_same(rank["tp"], single)
        _assert_same(rank["tp"], jax_mesh_outputs[:2])


def test_mesh_serving_with_model_axis_bf16(world):
    """(1, 2) in bf16 (the model's bf16 copy shares the mesh's groups),
    held as ``tests/test_torch_serving.py`` holds bf16 against f32: frame
    counts within its bar of the single device's, finite audio. (At these
    random weights a bf16 rounding moves phoneme boundaries in time, so
    two bf16 runs that round apart differ by whole samples.)"""
    single = _outputs(_synth(compute_dtype="bf16").synthesize_batch(
        TEXTS[:2], SCALE))
    for rank in world:
        for (fa, pa), (fb, _) in zip(rank["tp_bf16"], single):
            assert abs(fa - fb) <= max(2, fb // 50) and fa > 0
            assert pa.size == fa * 64 and np.any(pa)  # 4·4·2·2 a frame


def test_mesh_rejects_indivisible_batch_buckets(world):
    for rank in world:
        assert "not divisible" in rank["indivisible"]


def test_mesh_warmup_uses_shardable_single_stream(world):
    for rank in world:
        assert rank["shapes"] and all(b % 2 == 0
                                      for b, _, _ in rank["shapes"])


def test_data_parallel_server_leads_and_followers_follow(world):
    """``--data-parallel 2``: buckets (2, 8, 32); the leader's answers
    before and after a weight swap equal a single-device Synthesizer's on
    the same weights, and the follower leaves its loop on stop."""
    assert _server_args().data_parallel == 2
    assert world[0]["buckets"] == world[1]["buckets"] == (2, 8, 32)
    assert world[1]["followed"] and "led" not in world[1]
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    ref = [pipeline.from_config(FLAGSHIP_MODEL, seed=s, device="cpu",
                                compute_dtype="f32") for s in (0, 1)]
    _assert_same(world[0]["led"][0],
                 _outputs(ref[0].synthesize_batch(["hello world"], 4.0)))
    want = ref[1].synthesize_batch_long(["hello world. the quick brown fox"],
                                        4.0)
    (frames, pcm), = world[0]["led"][1]
    assert frames == want[0]["frames"] > 0
    assert np.abs(pcm.astype(np.int32) - want[0]["audio_pcm"]).max() <= 1


def test_data_parallel_server_survives_failed_calls(world):
    """A ``/reload`` whose checkpoint does not match gets its 400 on the
    leader and never reaches the follower; a call that fails on the
    follower alone is logged there and its loop goes on; the request after
    both is served on the mesh, equal to a single device on the swapped
    weights."""
    from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL

    reload_status, reload_error, status, pcm = world[0]["http"]
    assert reload_status == 400
    assert "differ" in reload_error or "mismatch" in reload_error
    assert status == 200
    want = pipeline.from_config(FLAGSHIP_MODEL, seed=1, device="cpu",
                                compute_dtype="f32").synthesize(
        "hello world", 4.0)["audio_pcm"]
    assert pcm.shape == want.shape and pcm.size > 0
    assert np.abs(pcm.astype(np.int32) - want).max() <= 1


def test_kernel_wrapper_refuses_a_dtensor(world):
    for rank in world:
        assert "DTensor" in rank["dtensor"]


def test_gloo_mesh_runs_no_graph(world):
    for rank in world:
        assert rank["graphs"] == (False, None, None, None)


@pytest.fixture(scope="module")
def jax_mesh_swapped():
    """JAX's mesh Synthesizer on seed 0's weights, swapped to seed 1's."""
    import jax

    from m2tts_tpu.models import M2TTS as JaxM2TTS
    from m2tts_tpu.parallel.mesh import make_mesh
    from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer
    from m2tts_tpu_torch.utils.params import to_flax

    def params(seed):
        return jax.tree_util.tree_map(np.asarray, to_flax(weights(seed)))

    js = JaxSynthesizer(JaxM2TTS(**KW), params(0), **BUCKETS,
                        mesh=make_mesh(data=2, devices=jax.devices()[:2]))
    js.swap_params(params(1))
    return _outputs(js.synthesize_batch(TEXTS, SCALE))


@pytest.mark.parametrize("layout", ["dp_f32", "tp_bf16"])
def test_mesh_swap_params_writes_in_place(world, jax_mesh_swapped, layout):
    single = _outputs(_synth(seed=1, vocoder_backend="mm",
                             compute_dtype=layout[3:]).synthesize_batch(
        TEXTS, SCALE))
    for rank in world:
        kept, got, fresh = rank["swap"][layout]
        assert kept
        _assert_same(got, fresh, lsb=0)
        if layout == "dp_f32":
            _assert_same(got, single)
            _assert_same(got, jax_mesh_swapped)
        else:  # bf16 as test_mesh_serving_with_model_axis_bf16 holds it
            for (fa, pa), (fb, _) in zip(got, single):
                assert abs(fa - fb) <= max(2, fb // 50) and fa > 0
                assert pa.size == fa * 64 and np.any(pa)


def test_server_data_parallel_needs_torchrun():
    from m2tts_tpu_torch.serving.server import build_synthesizer

    args = argparse.Namespace(**vars(_server_args()))
    with pytest.raises(RuntimeError, match="torchrun"):
        build_synthesizer(args)
