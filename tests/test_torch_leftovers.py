"""The last public pieces of the JAX package that the port lacked, against
the JAX package on the CPU:

- ``data/dataset.py``: ``DataLoader`` epochs (each ``iter()`` a fresh
  shuffle from ``seed``) and ``create_dataloader``'s default buckets, bit
  equal to JAX's batch for batch, ``drop_last`` both ways;
- ``models/tts_model.py``: ``count_parameters``, ``model_size_report``
  (exact); ``models/components.py``: ``clip_by_global_norm`` (1e-6: two
  libraries' float sums);
- ``ops/audio_codec.py``: ``mulaw_encode_f32`` (exact);
- ``frontend/audio.py``: ``compute_mel_spectrogram`` (JAX's own 2e-5), which
  ``AudioProcessor.compute_mel`` calls;
- ``utils/config.py``: ``save_config`` (the same bytes);
  ``utils/profiling.py``: ``annotate_step`` (a profiler range);
- ``data/download_data.py``: ``download_ljspeech`` from an archive already
  in the data dir and through a ``file://`` URL gives the JAX script's tree
  byte for byte; a fetch that fails exits 1. ``LJSPEECH_URL`` is
  monkeypatched in every case: nothing reaches the network.
"""

import tarfile
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.data import dataset as jds
from m2tts_tpu.frontend import audio as jaudio
from m2tts_tpu.models import components as jcomp
from m2tts_tpu.models import tts_model as jtts
from m2tts_tpu.ops import audio_codec as jcodec
from m2tts_tpu.utils import config as jconfig
from m2tts_tpu.utils import profiling as jprof
from m2tts_tpu_torch.data import dataset as tds
from m2tts_tpu_torch.data import download_data as tdd
from m2tts_tpu_torch.frontend import audio as taudio
from m2tts_tpu_torch.models import components as tcomp
from m2tts_tpu_torch.models import tts_model as ttts
from m2tts_tpu_torch.ops import audio_codec as tcodec
from m2tts_tpu_torch.utils import config as tconfig
from m2tts_tpu_torch.utils import profiling as tprof
from m2tts_tpu_torch.utils.params import from_flax
from scripts import download_data as jdd

torch.set_num_threads(2)

BUCKETS = [(20, 80), (40, 150)]
DATA = dict(size=29, mel_dim=8, max_text_length=40, max_mel_length=150,
            hop_length=64)
MEL_TOL = 2e-5  # tests/test_torch_native.py's, JAX's own NumPy bar


def _batches_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _epochs_equal(t, j, n=3):
    assert len(t) == len(j)
    for _ in range(n):  # each iter() is the next epoch
        got, want = list(t), list(j)
        assert len(got) == len(want) == len(t)
        for a, b in zip(got, want):
            _batches_equal(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_dataloader_epochs_bit_equal(seed, drop_last):
    kw = dict(batch_size=4, buckets=BUCKETS, seed=seed, audio_samples=256,
              drop_last=drop_last)
    t = tds.DataLoader(tds.DummyDataset(seed=seed, keep_audio=True, **DATA),
                       **kw)
    j = jds.DataLoader(jds.DummyDataset(seed=seed, keep_audio=True, **DATA),
                       **kw)
    _epochs_equal(t, j)
    # an unshuffled loader gives the same epoch every time
    ts = tds.DataLoader(tds.DummyDataset(seed=seed, **DATA), 4, BUCKETS,
                        shuffle=False, seed=seed, drop_last=drop_last)
    js = jds.DataLoader(jds.DummyDataset(seed=seed, **DATA), 4, BUCKETS,
                        shuffle=False, seed=seed, drop_last=drop_last)
    _epochs_equal(ts, js, n=2)


def test_create_dataloader_default_buckets():
    kw = dict(DATA, max_text_length=200, max_mel_length=900)
    t = tds.create_dataloader(tds.DummyDataset(**kw), batch_size=3, seed=4)
    j = jds.create_dataloader(jds.DummyDataset(**kw), batch_size=3, seed=4)
    assert t.buckets == j.buckets == [(64, 256), (128, 512), (256, 1000)]
    _epochs_equal(t, j, n=2)


KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)


def test_parameter_counts_match_jax():
    params = jax.device_get(jax.jit(partial(
        jtts.M2TTS(**KW).init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    model = ttts.M2TTS(**KW)
    model.load_state_dict(from_flax(params))
    want = jtts.count_parameters(params)
    assert ttts.count_parameters(model) == want
    assert ttts.count_parameters(model.state_dict()) == want
    report = jtts.model_size_report(params)
    assert ttts.model_size_report(model) == report
    assert ttts.model_size_report(model.state_dict()) == report
    assert set(report["components"]) == {"text_encoder", "duration_predictor",
                                         "decoder", "vocoder"}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])  # clipped, not clipped
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    grads = {"a": rng.normal(size=(3, 5)).astype(np.float32),
             "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    want, want_norm = jcomp.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    got, got_norm = tcomp.clip_by_global_norm(
        {"a": torch.from_numpy(grads["a"]),
         "b": {"c": torch.from_numpy(grads["b"]["c"])}}, max_norm)
    np.testing.assert_allclose(got_norm.numpy(), np.asarray(want_norm),
                               rtol=1e-6)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=1e-6)


def test_mulaw_encode_f32_matches_jax():
    rng = np.random.default_rng(2)
    audio = np.concatenate([
        rng.uniform(-1.5, 1.5, 4096),
        [-1.0, 1.0, 0.0, -0.0, 1e-6, -1e-6, 0.5, -0.5, 2.0, -2.0]
    ]).astype(np.float32)
    want = np.asarray(jcodec.mulaw_encode_f32(jnp.asarray(audio)))
    got = tcodec.mulaw_encode_f32(torch.from_numpy(audio))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [{}, dict(sample_rate=16000, n_fft=512,
                                         hop_length=128, win_length=400,
                                         n_mels=40, fmin=50.0, fmax=7000.0)],
                         ids=["default", "nondefault"])
def test_compute_mel_spectrogram_matches_jax(kw):
    rng = np.random.default_rng(3)
    audio = (np.sin(np.linspace(0, 300, 9000)) * 0.3
             + 0.05 * rng.normal(size=9000)).astype(np.float32)
    got = taudio.compute_mel_spectrogram(audio, **kw)
    want = jaudio.compute_mel_spectrogram(audio, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)
    np.testing.assert_array_equal(
        taudio.AudioProcessor(use_native=False, **kw).compute_mel(audio), got)
    silent = np.zeros(2048, np.float32)  # the flat-spectrum branch
    np.testing.assert_array_equal(taudio.compute_mel_spectrogram(silent),
                                  jaudio.compute_mel_spectrogram(silent))


def test_save_config_writes_jax_bytes(tmp_path):
    data = {"model": {"hidden_dim": 96, "upsample_rates": [8, 8, 2, 2]},
            "training": {"learning_rate": 2e-4, "bf16": True},
            "data": {"buckets": [[64, 256]], "fmax": None}}
    jconfig.save_config(jconfig.Config(data), tmp_path / "jax" / "c.yaml")
    tconfig.save_config(tconfig.Config(data), tmp_path / "port" / "c.yaml")
    assert (tmp_path / "port" / "c.yaml").read_bytes() == \
        (tmp_path / "jax" / "c.yaml").read_bytes()
    assert tconfig.load_config(tmp_path / "port" / "c.yaml").to_dict() == data


def test_annotate_step_is_a_profiler_range():
    for args in (("decode",), ("train", 3)):
        with jprof.annotate_step(*args):  # the JAX package's accepts both
            pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.annotate_step("decode"):
            torch.ones(2).sum()
        with tprof.annotate_step("train", 3):
            torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert {"decode", "train#3"} <= names


# -- the archive half of the download CLI ---------------------------------

def _ljspeech_archive(root: Path) -> Path:
    """A complete small LJSpeech-1.1 tree packed as LJSpeech-1.1.tar.bz2."""
    from m2tts_tpu_torch.frontend.audio import save_wav

    tree = root / "src" / "LJSpeech-1.1"
    rows = []
    for i in range(4):
        fid = f"LJ001-{i:04d}"
        rows.append(f"{fid}|Text {i}.|Text {i}.\n")
        save_wav(np.full(64, 0.1 * i, np.float32), tree / "wavs" / f"{fid}.wav")
    (tree / "metadata.csv").write_text("".join(rows))
    archive = root / "LJSpeech-1.1.tar.bz2"
    with tarfile.open(archive, "w:bz2") as tar:
        tar.add(tree, arcname="LJSpeech-1.1")
    return archive


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def archive(tmp_path, monkeypatch):
    """The archive, and both modules' URL on a file:// path that does not
    exist, so a fetch a case does not expect fails at once."""
    absent = (tmp_path / "absent" / "LJSpeech-1.1.tar.bz2").as_uri()
    monkeypatch.setattr(jdd, "LJSPEECH_URL", absent)
    monkeypatch.setattr(tdd, "LJSPEECH_URL", absent)
    return _ljspeech_archive(tmp_path)


@pytest.mark.parametrize("how", ["present", "file_url"])
def test_download_ljspeech_builds_jax_tree(archive, tmp_path, monkeypatch,
                                           capsys, how):
    trees = {}
    for name, mod in (("jax", jdd), ("port", tdd)):
        data_dir = tmp_path / name
        data_dir.mkdir()
        if how == "present":
            (data_dir / archive.name).write_bytes(archive.read_bytes())
        else:
            monkeypatch.setattr(mod, "LJSPEECH_URL", archive.as_uri())
        out = mod.download_ljspeech(data_dir, subset_size=2)
        assert out == data_dir / "LJSpeech-1.1-subset-2"
        assert not (data_dir / archive.name).exists()  # removed after
        said = capsys.readouterr()
        trees[name] = (_tree(data_dir),
                       said.out.replace(str(data_dir), "<dir>"))
    assert trees["port"] == trees["jax"]
    files = trees["port"][0]
    assert "LJSpeech-1.1/metadata.csv" in files and len(files) == 4 + 1 + 2 + 1
    # a verified tree is kept: no archive and no fetch needed again
    assert tdd.download_ljspeech(tmp_path / "port") == \
        tmp_path / "port" / "LJSpeech-1.1"


def test_download_ljspeech_failed_fetch_exits_1(archive, tmp_path, capsys):
    for mod in (jdd, tdd):
        with pytest.raises(SystemExit) as e:
            mod.download_ljspeech(tmp_path / mod.__name__)
        assert e.value.code == 1
        assert "Download failed" in capsys.readouterr().out
        assert not list((tmp_path / mod.__name__).iterdir())  # no .part
