"""The synthesize and evaluate CLIs of the PyTorch port
(``serving/synthesize.py``, ``evaluation/evaluate.py``) against the JAX
package's ``scripts/synthesize.py`` and ``scripts/evaluate.py``, each run
in-process through ``main(argv)`` on the same weights, on the CPU at
``--compute-dtype f32``: the JAX CLIs read an orbax checkpoint, the port's
the same checkpoint converted by ``tools/orbax_to_torch.py`` (hidden 32,
16 mels, 32 vocoder channels, 1+1 layers, default buckets).

- synthesize: ``--text``; a ``--batch-file`` of 33 lines (more than the
  largest batch bucket, 32: two batches); a ``--batch-file`` with a line
  over the phoneme budget (the long-form path); ``--streaming`` (also
  against the stream's own mel vocoded whole, which is what the streamed
  WAV equals in both packages). The same WAV files, samples within ±1 LSB.
- ``--griffin-lim``: the mels within 1e-5, the port's Griffin-Lim on one
  mel within 1e-5 of JAX's, and each CLI's WAV within ±1 LSB of Griffin-Lim
  on its mel (Griffin-Lim turns the mels' ~1e-6 apart into ~1e-4, so the
  two CLIs' WAVs are held link by link, not to each other).
- evaluate: ``-t`` (MOS within 1e-3) and ``--data-dir --audio-metrics``
  on a tiny generated LJSpeech-layout corpus (every metric within rtol
  1e-4, atol 1e-5, as the report rounds to 5 decimals; the log-spectral
  distance within 1e-2, see ``RTOL``).
"""

import contextlib
import io
import json
import sys
import wave
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.frontend import audio as jaudio
from m2tts_tpu.models import build_model as jax_build_model
from m2tts_tpu.serving import pipeline as jpipeline
from m2tts_tpu.utils.checkpoint import CheckpointManager as OrbaxManager
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.evaluation import evaluate as tevaluate
from m2tts_tpu_torch.frontend import audio as taudio
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.serving import synthesize as tsynthesize

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import scripts.evaluate as jevaluate  # noqa: E402
import scripts.synthesize as jsynthesize  # noqa: E402
from tools.orbax_to_torch import convert  # noqa: E402

torch.set_num_threads(2)

CONFIG = {
    "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                               "num_layers": 1, "num_heads": 2,
                               "dropout": 0.0},
              "decoder": {"mel_channels": 16, "num_layers": 1},
              "vocoder": {"hidden_channels": 32}},
    "data": {"sample_rate": 22050, "hop_length": 256, "n_mels": 16,
             "buckets": [[64, 128]]},
}
SCALE = "6.0"  # random-init durations are ~0.3 frames a phoneme
SHORT = ["hello world", "the quick brown fox jumps", "a test of speech",
         "speech synthesis on a card"]
LONG = ("the quick brown fox jumps over the lazy dog. " * 12).strip()
F32 = ["--compute-dtype", "f32", "--duration-scale", SCALE]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(orbax dir, converted dir) of one tiny model."""
    root = tmp_path_factory.mktemp("cli")
    cfg = JaxConfig(CONFIG)
    model = jax_build_model(cfg.model)
    params = jax.device_get(jax.jit(partial(
        model.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    mgr = OrbaxManager(root / "orbax")
    mgr.save(1, {"params": params["params"], "step": 1}, config=cfg)
    mgr.close()
    convert(root / "orbax", root / "port")
    return root / "orbax", root / "port"


def _read_wav(path: Path) -> np.ndarray:
    with wave.open(str(path), "rb") as f:
        assert f.getframerate() == 22050 and f.getsampwidth() == 2
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _both(ckpt, tmp_path, args, names):
    """Run both CLIs with ``args``; the WAVs ``names`` of each side."""
    orbax, port = ckpt
    _run(jsynthesize.main, ["--checkpoint", str(orbax), "--output",
                            str(tmp_path / "jax" / "out.wav"), *args])
    log = _run(tsynthesize.main, ["--checkpoint", str(port), "--device",
                                  "cpu", "--output",
                                  str(tmp_path / "port" / "out.wav"), *args])
    return ([_read_wav(tmp_path / side / n) for n in names]
            for side in ("jax", "port")), log


def _within_one_lsb(refs, gots):
    for ref, got in zip(refs, gots):
        assert got.shape == ref.shape and ref.size > 0
        assert np.abs(got.astype(np.int32) - ref).max() <= 1


def _batch_file(tmp_path, lines):
    bf = tmp_path / "lines.txt"
    bf.write_text("\n".join(lines) + "\n")
    return ["--batch-file", str(bf)]


@pytest.mark.parametrize("case", ["text", "batch33", "over_budget",
                                  "streaming"])
def test_synthesize_matches_jax(ckpt, tmp_path, case):
    if case == "text":
        args, names = ["--text", SHORT[1]], ["out.wav"]
    elif case == "streaming":
        args, names = ["--text", LONG[:120], "--streaming"], ["out.wav"]
    else:
        lines = ((SHORT * 9)[:33] if case == "batch33"
                 else [SHORT[0], LONG, SHORT[2]])
        args = _batch_file(tmp_path, lines)
        names = [f"out_{i:03d}.wav" for i in range(len(lines))]
    (refs, gots), log = _both(ckpt, tmp_path, args + F32, names)
    refs, gots = list(refs), list(gots)
    _within_one_lsb(refs, gots)
    if case == "over_budget":
        assert "long-form: 1/3 text(s) over the 254-phoneme budget" in log
        assert len(gots[1]) > 4 * len(gots[0])
    if case == "streaming":
        assert "first-chunk latency" in log and "RTF" in log
        _within_one_lsb([_stream_whole(ckpt[1], LONG[:120])], gots)


def _stream_whole(port_dir, text):
    """The int16 PCM of the stream's own mel (max_frames 1000) vocoded
    whole: what the streamed WAV equals (the batch path's WAV does not,
    in either package: its decoder attends over the padding frames of a
    smaller frame bucket)."""
    from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer

    synth = pipeline.from_checkpoint(port_dir, compute_dtype="f32",
                                     device="cpu")
    ss = StreamingSynthesizer(synth.model, compute_dtype="f32",
                              device="cpu")
    assert ss.split_long(text) == [text]
    enc = ss.text_processor.batch([text], ss.text_bucket)
    with torch.no_grad():
        mel, total = ss._acoustic(torch.from_numpy(enc["phoneme_ids"]),
                                  torch.from_numpy(enc["lengths"]),
                                  float(SCALE))
        frames = min(int(total[0]), ss.max_frames)
        audio = synth.model.vocoder(mel[:, :frames])[0, :, 0]
    return pipeline.quantize_pcm16(audio).numpy()


def test_griffin_lim_matches_jax(ckpt, tmp_path):
    """Griffin-Lim amplifies its input's rounding: the two packages' f32
    mels differ by ~1e-6 and their Griffin-Lim outputs then by ~1e-4
    (32 momentum iterations; 1.1e-4, 3.5 LSB, measured). So the chain is
    held link by link: the mels within 1e-5, the port's Griffin-Lim on
    JAX's mel within 1e-5 of JAX's (equal in practice), and each CLI's WAV
    within ±1 LSB of its package's Griffin-Lim on the port's mel."""
    orbax, port = ckpt
    (refs, gots), _ = _both(ckpt, tmp_path, ["--text", SHORT[1],
                                             "--griffin-lim", *F32],
                            ["out.wav"])
    jmel = np.asarray(jpipeline.from_checkpoint(
        str(orbax), compute_dtype="f32").synthesize_batch(
        [SHORT[1]], float(SCALE), want_mel=True)[0]["mel"])
    tmel = pipeline.from_checkpoint(port, compute_dtype="f32", device="cpu") \
        .synthesize_batch([SHORT[1]], float(SCALE), want_mel=True)[0]["mel"]
    assert tmel.shape == jmel.shape
    np.testing.assert_allclose(tmel, jmel, rtol=0, atol=1e-5)
    jgl = jaudio.AudioProcessor(n_mels=16, use_native=False).mel_to_audio
    tgl = taudio.AudioProcessor(n_mels=16, use_native=False).mel_to_audio
    np.testing.assert_allclose(tgl(jmel.T), jgl(jmel.T), rtol=0, atol=1e-5)
    on_port_mel = jgl(tmel.T)
    pcm = (np.clip(on_port_mel, -1, 1) * 32767).astype(np.int16)
    _within_one_lsb([pcm], list(gots))
    _within_one_lsb([(np.clip(jgl(jmel.T), -1, 1) * 32767).astype(np.int16)],
                    list(refs))


def test_streaming_needs_one_text(ckpt, tmp_path):
    with pytest.raises(SystemExit):
        tsynthesize.main(["--checkpoint", str(ckpt[1]), "--device", "cpu",
                          "--streaming", "--griffin-lim", "--text", "a",
                          "--output", str(tmp_path / "x.wav")])


def _corpus(root: Path) -> Path:
    """Four LJSpeech-layout clips of harmonic tones in noise."""
    (root / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(SHORT):
        n = 11025 + 2205 * i
        t = np.arange(n) / 22050
        f0 = 140.0 + 20 * i
        audio = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3))
        audio = 0.3 * audio + 0.01 * rng.standard_normal(n)
        taudio.save_wav(audio / np.abs(audio).max() * 0.8,
                        root / "wavs" / f"LJ001-{i:04d}.wav")
        lines.append(f"LJ001-{i:04d}|{text}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines) + "\n")
    return root


# the report rounds to 5 decimals. The log-spectral distance takes
# log(|X| + 1e-8) of every STFT bin of the teacher-forced waveform, and the
# random-init vocoder leaves 43% of them below 1e-6, where the two
# packages' f32 rounding (the waveforms agree within 1 LSB) moves the log:
# it is held at 1e-2 (1.9e-3 measured), and its function on one waveform
# exactly (test_log_spectral_distance_function_matches_jax)
RTOL = {"audio_log_spectral_distance": 1e-2}


def _close(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _close(got[k], ref[k], f"{path}.{k}" if path else k)
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        key = path.rsplit(".", 1)[-1]
        if "estimated_mos" in key:
            assert abs(got - ref) <= 1e-3, path
        else:
            np.testing.assert_allclose(got, ref, rtol=RTOL.get(key, 1e-4),
                                       atol=1e-5, err_msg=path)
    else:
        assert got == ref, path


def test_log_spectral_distance_function_matches_jax():
    from m2tts_tpu.evaluation import metrics as jmetrics
    from m2tts_tpu_torch.evaluation import metrics as tmetrics

    rng = np.random.default_rng(0)
    pred, gt = np.tanh(rng.standard_normal((2, 8192)) * 3)
    assert tmetrics.compute_log_spectral_distance(pred, gt) \
        == jmetrics.compute_log_spectral_distance(pred, gt)


def test_evaluate_matches_jax(ckpt, tmp_path):
    orbax, port = ckpt
    common = ["--json", "--audio-metrics", "--batch-size", "2",
              "--duration-scale", SCALE, "-t", SHORT[0], "-t", SHORT[3]]
    ref = json.loads(_run(jevaluate.main, [
        "--checkpoint", str(orbax), "--data-dir",
        str(_corpus(tmp_path / "jax")), *common]).strip().splitlines()[-1])
    got = json.loads(_run(tevaluate.main, [
        "--checkpoint", str(port), "--device", "cpu", "--data-dir",
        str(_corpus(tmp_path / "port")), *common]).strip().splitlines()[-1])
    assert {"dataset", "texts", "estimated_mos_mean"} <= set(got)
    assert "audio_stoi" in got["dataset"]
    assert "mel_l1_distance" in got["dataset"]
    _close(got, ref)


def test_evaluate_report_and_wavs(ckpt, tmp_path):
    log = _run(tevaluate.main, ["--checkpoint", str(ckpt[1]), "--device",
                                "cpu", "-t", SHORT[0], "--duration-scale",
                                SCALE, "--dump-wavs", str(tmp_path)])
    assert "mean estimated MOS" in log
    assert _read_wav(tmp_path / "eval_000.wav").size > 0
