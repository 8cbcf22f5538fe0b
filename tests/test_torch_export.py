"""``torch.export`` serving artifacts of the PyTorch port
(``serving/export.py``, ``serving/export_model.py``) on the CPU, at the
tiny widths of ``tests/test_export.py`` (hidden 32, 16 mels, 32 vocoder
channels, 1+1 layers), the JAX weights carried by ``from_flax``:

- the manifest keeps the JAX artifact's keys; ``full=True`` writes
  2 × 2 × 2 graphs and 2 × 2 probes, ``full=False`` batch {1} only;
- ``params.npz`` round-trips the weights exactly, and no graph lifts a
  weight (each program's ``state_dict`` is empty, its constants scalars);
- ``ExportedSynthesizer`` equals the port's live ``torch``-backend
  synthesizer exactly (frames and PCM) in f32 at scales 1.0 and 1.5, and
  in bf16 (the graph casts its f32 weight inputs);
- it is within ±1 LSB of the JAX ``ExportedSynthesizer`` exported from the
  same weights, with equal frames (f32 on both sides; the convolution and
  matmul libraries differ, so the last bit of the waveform may);
- the lexicon travels in the manifest, and the ``export_model`` CLI works.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import M2TTS as JaxM2TTS
from m2tts_tpu.serving.export import ExportedSynthesizer as JaxExported
from m2tts_tpu.serving.export import export_synthesizer as jax_export
from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer
from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.serving import export_model
from m2tts_tpu_torch.serving.export import (ExportedSynthesizer,
                                            export_synthesizer)
from m2tts_tpu_torch.serving.pipeline import Synthesizer
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(32, 64),
               batch_buckets=(1, 2))
# the keys of the JAX manifest (m2tts_tpu/serving/export.py:117-134)
JAX_KEYS = {"artifact_version", "platforms", "sample_rate", "upsample",
            "compute_dtype", "text_buckets", "frame_buckets",
            "batch_buckets", "params_file", "extra_lexicon", "graphs",
            "probes"}
TEXTS = ["hello exported world", "two at once"]


@pytest.fixture(scope="module")
def weights():
    model = JaxM2TTS(**KW)
    params = jax.device_get(jax.jit(partial(
        model.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


def _port_model(params):
    m = M2TTS(**KW)
    m.load_state_dict(from_flax(params), strict=True)
    return m


@pytest.fixture(scope="module")
def synth(weights):
    s = Synthesizer(_port_model(weights[1]), device="cpu", **BUCKETS)
    assert (s.vocoder_backend, s.compute_dtype) == ("torch", "f32")
    return s


@pytest.fixture(scope="module")
def artifact(synth, tmp_path_factory):
    out = tmp_path_factory.mktemp("export")
    manifest = export_synthesizer(synth, out, full=True)
    return out, manifest


def test_manifest_and_files(artifact):
    out, manifest = artifact
    assert JAX_KEYS <= set(manifest)
    assert manifest["artifact_version"] == 1
    assert manifest["platforms"] == ["cpu"]
    assert manifest["traced_device"] == "cpu"
    assert len(manifest["graphs"]) == 2 * 2 * 2
    assert len(manifest["probes"]) == 2 * 2
    assert manifest["batch_buckets"] == [1, 2]
    for g in manifest["graphs"] + manifest["probes"]:
        assert (out / g["file"]).stat().st_size > 0
        assert g["file"].endswith(".pt2")
    assert json.loads((out / "manifest.json").read_text()) == manifest


def test_params_roundtrip_exact(artifact, synth):
    out, _ = artifact
    ex = ExportedSynthesizer(out, device="cpu")
    live = synth.model.state_dict()
    assert set(ex.params) == set(live)
    for k, v in live.items():
        assert ex.params[k].dtype == v.dtype
        assert torch.equal(ex.params[k], v), k
    with np.load(out / "params.npz") as z:
        assert all("/" in k and "." not in k for k in z.files)


def test_no_graph_lifts_a_weight(artifact):
    out, manifest = artifact
    for g in manifest["graphs"] + manifest["probes"]:
        ep = torch.export.load(out / g["file"])
        assert ep.state_dict == {}, g["file"]
        assert ep.example_inputs is None, g["file"]
        # only scalar constants (the √d embedding scale): no weight baked in
        assert sum(v.numel() for v in ep.constants.values()
                   if isinstance(v, torch.Tensor)) <= 2, g["file"]


@pytest.mark.parametrize("scale", [1.0, 1.5, 12.0])
def test_exported_equals_live_synthesizer(artifact, synth, scale):
    out, _ = artifact
    ex = ExportedSynthesizer(out, device="cpu")
    live = synth.synthesize_batch(TEXTS, scale)
    back = ex.synthesize_batch(TEXTS, scale)
    for lr, br in zip(live, back):
        assert lr["frames"] == br["frames"]
        np.testing.assert_array_equal(lr["audio_pcm"], br["audio_pcm"])
        assert br["audio"].dtype == np.float32
    single = ex.synthesize("scaled speech", scale)
    ref = synth.synthesize("scaled speech", scale)
    assert single["frames"] == ref["frames"]
    np.testing.assert_array_equal(single["audio_pcm"], ref["audio_pcm"])


def test_bf16_graph_casts_its_weight_inputs(synth, tmp_path):
    bf16 = Synthesizer(synth.model, device="cpu", compute_dtype="bf16",
                       vocoder_backend="torch", **BUCKETS)
    manifest = export_synthesizer(bf16, tmp_path)
    assert manifest["compute_dtype"] == "bf16"
    ex = ExportedSynthesizer(tmp_path, device="cpu")
    assert all(v.dtype != torch.bfloat16 for v in ex.params.values())
    for lr, br in zip(bf16.synthesize_batch(TEXTS[:1], 12.0),
                      ex.synthesize_batch(TEXTS[:1], 12.0)):
        assert lr["frames"] == br["frames"] > 0
        np.testing.assert_array_equal(lr["audio_pcm"], br["audio_pcm"])


@pytest.fixture(scope="module")
def jax_pair(weights, tmp_path_factory):
    """The JAX and the port artifact of the same weights (one text bucket,
    two frame buckets, batch 1)."""
    model, params = weights
    small = dict(text_buckets=(16,), frame_buckets=(32, 64),
                 batch_buckets=(1,))
    root = tmp_path_factory.mktemp("pair")
    jax_export(JaxSynthesizer(model, params, **small), root / "jax")
    export_synthesizer(Synthesizer(_port_model(params), device="cpu",
                                   **small), root / "port")
    return JaxExported(root / "jax"), ExportedSynthesizer(root / "port",
                                                          device="cpu")


@pytest.mark.parametrize("scale", [1.0, 1.5, 6.0])
def test_exported_matches_jax_artifact(jax_pair, scale):
    jex, tex = jax_pair
    for text in ("hello world", "scaled speech"):
        ref, got = jex.synthesize(text, scale), tex.synthesize(text, scale)
        assert got["frames"] == ref["frames"]
        assert got["audio_pcm"].shape == ref["audio_pcm"].shape
        if ref["audio_pcm"].size:
            assert np.abs(got["audio_pcm"].astype(np.int32)
                          - ref["audio_pcm"]).max() <= 1


def test_single_stream_export_is_small(synth, tmp_path):
    manifest = export_synthesizer(synth, tmp_path, full=False,
                                  platforms=("cuda", "cpu"))
    assert {g["batch"] for g in manifest["graphs"]} == {1}
    assert len(manifest["graphs"]) == 2 * 2 and len(manifest["probes"]) == 2
    assert manifest["platforms"] == ["cuda", "cpu"]
    assert manifest["device_move"].endswith("move_to_device_pass")


def test_unknown_platform_raises(synth, tmp_path):
    with pytest.raises(ValueError):
        export_synthesizer(synth, tmp_path, platforms=("tpu",))
    assert not (tmp_path / "manifest.json").exists()


def test_lexicon_travels_in_manifest(weights, tmp_path):
    lex = {"zyzzyva": ["Z", "IH", "Z", "IH", "V", "AH"]}
    s = Synthesizer(_port_model(weights[1]), text_buckets=(16,),
                    frame_buckets=(32,), batch_buckets=(1,),
                    extra_lexicon=lex, device="cpu")
    manifest = export_synthesizer(s, tmp_path)
    assert manifest["extra_lexicon"] == lex
    ex = ExportedSynthesizer(tmp_path, device="cpu")
    assert (ex.text_processor.text_to_phonemes("zyzzyva")
            == s.text_processor.text_to_phonemes("zyzzyva"))
    np.testing.assert_array_equal(s.synthesize("zyzzyva", 4.0)["audio_pcm"],
                                  ex.synthesize("zyzzyva", 4.0)["audio_pcm"])


def test_cli_export(synth, tmp_path, monkeypatch, capsys):
    # stub the factory so the CLI exports the tiny fixture model
    seen = {}

    def from_config(cfg, **kw):
        seen.update(kw)
        return synth

    monkeypatch.setattr("m2tts_tpu_torch.serving.pipeline.from_config",
                        from_config)
    rc = export_model.main(["--random-init", "--device", "cpu",
                            "--output", str(tmp_path / "art")])
    assert rc == 0
    assert seen == {"compute_dtype": "auto", "device": "cpu",
                    "vocoder_backend": "torch"}
    assert "exported 4 synthesis graphs + 2 probes for platforms ['cpu']" \
        in capsys.readouterr().out
    ex = ExportedSynthesizer(tmp_path / "art", device="cpu")
    r = ex.synthesize("command line artifact", 4.0)
    assert r["audio_pcm"].dtype == np.int16 and len(r["audio_pcm"]) > 0
