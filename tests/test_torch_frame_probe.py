"""The port's host frame probe (``Synthesizer(frame_probe='host')``) against
the JAX package's, on the CPU in f32, on the buckets and texts of
``tests/test_serving.py::test_host_frame_probe_matches_device``:

- the host probe's frame counts equal JAX's host probe's exactly, and so do
  the chosen frame bucket and each utterance's ``frames``; int16 PCM within
  ±1 LSB;
- within the port, 'host' and 'device' pick the same bucket and give the
  same PCM;
- after ``swap_params`` to weights with longer durations, the host probe
  routes as a fresh JAX host-probe Synthesizer on the new weights (JAX's
  own swap keeps its stale copy, ``ADVICE.md:3``);
- 'auto' is 'device', an unknown name raises, the host probe's failure is
  raised (no fall-back), ``warmup`` runs the host probe once a (batch,
  text);
- on a two-rank gloo mesh, (2, 1) and (1, 2), 'host' serves what one
  device serves, and a swap on the (1, 2) mesh routes by the new weights.

The mesh ranks import no JAX: the module imports it only inside fixtures.
"""

from functools import partial

import numpy as np
import pytest
import torch

from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.parallel import mesh as pmesh
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.serving.pipeline import Synthesizer
from m2tts_tpu_torch.utils.params import from_flax, to_flax

torch.set_num_threads(2)

KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
               batch_buckets=(1, 2, 4))
TEXTS = ["hello world", "the quick brown fox jumps over the dog"]
SCALES = (0.8, 1.0, 3.0, 12.0)
SWAP_SCALE = 3.0
# added to the duration head's bias: softplus(x + 3) ≈ x + 3 frames a
# phoneme, so the swapped weights need the 128-frame bucket at SWAP_SCALE
LONGER = 3.0
DURATION_BIAS = "duration_predictor.predictor.proj.conv.bias"


@pytest.fixture(scope="module")
def weights():
    """(seed 0's weights, the same with longer durations), initialised by
    the JAX model and carried across with ``from_flax``."""
    import jax
    import jax.numpy as jnp

    from m2tts_tpu.models import M2TTS as JaxM2TTS

    params = jax.device_get(jax.jit(partial(
        JaxM2TTS(**KW).init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    first = from_flax(params)
    longer = dict(first)
    longer[DURATION_BIAS] = first[DURATION_BIAS] + LONGER
    return first, longer


def _port(state, **kw) -> Synthesizer:
    model = M2TTS(**KW)
    model.load_state_dict(state)
    return Synthesizer(model, device="cpu", **{**BUCKETS, **kw})


def _jax(state, **kw):
    import jax

    from m2tts_tpu.models import M2TTS as JaxM2TTS
    from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer

    params = jax.tree_util.tree_map(np.asarray, to_flax(state))
    return JaxSynthesizer(JaxM2TTS(**KW), params, **{**BUCKETS, **kw})


@pytest.fixture(scope="module")
def synths(weights):
    first, _ = weights
    js = _jax(first, frame_probe="host")
    assert js.frame_probe == "host"
    return js, _port(first, frame_probe="host"), _port(first,
                                                       frame_probe="device")


def _outputs(results):
    return [(r["frames"], r.get("truncated"), r["audio_pcm"])
            for r in results]


def _assert_same(got, want, lsb=1):
    assert len(got) == len(want)
    for (fa, ta, pa), (fb, tb, pb) in zip(got, want):
        assert fa == fb and ta == tb
        assert pa.shape == pb.shape
        if pa.size:
            assert np.abs(pa.astype(np.int32) - pb).max() <= lsb


def _launched(s, scale):
    """(frame bucket, results) of one batch through ``_launch``."""
    out, max_frames = s._launch(TEXTS, scale, None, False)
    return max_frames, _outputs(s._collect(out, max_frames, len(TEXTS),
                                           False))


@pytest.mark.parametrize("scale", SCALES)
def test_host_probe_matches_jax(synths, scale):
    js, th, _ = synths
    ids, lengths = js._encode_batch(TEXTS)
    want = js._predict_frames_host(ids, lengths, scale)
    np.testing.assert_array_equal(th.predict_frames_host(ids, lengths, scale),
                                  want)
    j_bucket, j_out = _launched(js, scale)
    t_bucket, t_out = _launched(th, scale)
    assert t_bucket == j_bucket
    _assert_same(t_out, j_out)


@pytest.mark.parametrize("scale", SCALES)
def test_host_and_device_probes_agree(synths, scale):
    _, th, td = synths
    packed = pipeline.encode_packed_batch(th.text_processor, TEXTS,
                                          th.batch_buckets, th.text_buckets)
    np.testing.assert_array_equal(
        th.predict_frames_host(packed[:, :-1], packed[:, -1], scale),
        td.predict_frames(packed[:, :-1], packed[:, -1], scale))
    h_bucket, h_out = _launched(th, scale)
    d_bucket, d_out = _launched(td, scale)
    assert h_bucket == d_bucket
    _assert_same(h_out, d_out, lsb=0)


def test_swap_params_routes_by_new_weights(weights):
    first, longer = weights
    ts = _port(first, frame_probe="host")
    before, _ = _launched(ts, SWAP_SCALE)
    ts.swap_params(longer)
    fresh = _jax(longer, frame_probe="host")
    ids, lengths = fresh._encode_batch(TEXTS)
    np.testing.assert_array_equal(
        ts.predict_frames_host(ids, lengths, SWAP_SCALE),
        fresh._predict_frames_host(ids, lengths, SWAP_SCALE))
    j_bucket, j_out = _launched(fresh, SWAP_SCALE)
    t_bucket, t_out = _launched(ts, SWAP_SCALE)
    assert before != t_bucket == j_bucket  # the new durations route it
    _assert_same(t_out, j_out)


def test_frame_probe_routing(weights, monkeypatch):
    first, _ = weights
    assert pipeline.resolve_frame_probe("auto") == "device"
    device = _port(first)
    assert device.frame_probe == "device" and device._host is None
    with pytest.raises(ValueError):
        _port(first, frame_probe="cpu")
    with pytest.raises(ValueError):
        device.predict_frames_host(np.zeros((1, 16), np.int32),
                                   np.ones(1, np.int32))

    calls = []
    probe = pipeline.HostProbe.probe

    def counted(self, packed, duration_scale):
        calls.append(packed.shape)
        return probe(self, packed, duration_scale)

    monkeypatch.setattr(pipeline.HostProbe, "probe", counted)
    host = _port(first, frame_probe="host")
    shapes = host.reachable_shapes(full=False)
    assert host.warmup() == len(shapes)
    assert sorted(calls) == sorted({(b, t + 1) for b, t, _ in shapes})

    def broken(self, packed, duration_scale):
        raise RuntimeError("host probe down")

    monkeypatch.setattr(pipeline.HostProbe, "probe", broken)
    with pytest.raises(RuntimeError, match="host probe down"):
        host.synthesize_batch(TEXTS, 3.0)  # never the device probe instead


# -- what the mesh ranks run (no JAX) ----------------------------------------

MESH_BUCKETS = dict(batch_buckets=(2, 4))


def _mesh_world(first, longer):
    res = {}
    for name, shape in (("dp", (2, 1)), ("tp", (1, 2))):
        mesh = pmesh.make_mesh(*shape, device_type="cpu")
        s = _port(first, mesh=mesh, frame_probe="host", **MESH_BUCKETS)
        res[name] = _outputs(s.synthesize_batch(TEXTS, SWAP_SCALE))
    s.swap_params(longer)
    res["tp_swapped"] = _outputs(s.synthesize_batch(TEXTS, SWAP_SCALE))
    return res


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    return pmesh.spawn_world(_mesh_world, 2, args=weights,
                             workdir=str(tmp_path_factory.mktemp("probe")))


def test_mesh_host_probe_matches_one_device(weights, world):
    first, longer = weights
    single = _outputs(_port(first, frame_probe="host", **MESH_BUCKETS)
                      .synthesize_batch(TEXTS, SWAP_SCALE))
    swapped = _outputs(_port(longer, frame_probe="host", **MESH_BUCKETS)
                       .synthesize_batch(TEXTS, SWAP_SCALE))
    assert [f for f, _, _ in single] != [f for f, _, _ in swapped]
    for rank in world:
        _assert_same(rank["dp"], single)
        _assert_same(rank["tp"], single)
        _assert_same(rank["tp_swapped"], swapped)
