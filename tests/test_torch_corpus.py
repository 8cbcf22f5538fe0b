"""The port's offline corpus tools (``data/download_data.py``,
``evaluation/corpus_floors.py``) against the JAX package's scripts: the
synthetic corpus of every profile byte for byte, each renderer's arrays,
the LJSpeech verifier and subset builder, the floors' JSON (1e-5), and the
CLI's exit codes (the LJSpeech download from a local archive; no case
reaches the network)."""

import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from m2tts_tpu_torch.data import download_data as tdd
from m2tts_tpu_torch.evaluation import corpus_floors as tfloors
from scripts import corpus_floors as jfloors
from scripts import download_data as jdd

torch.set_num_threads(2)

N = 3
FLOORS_TOL = 1e-5


def _files(corpus: Path) -> list:
    return ["metadata.csv"] + sorted(
        f"wavs/{p.name}" for p in (corpus / "wavs").iterdir())


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The v3 corpus at N from both builders (the floors' input)."""
    root = tmp_path_factory.mktemp("corpora")
    return (jdd.build_synthetic_corpus(root / "jax", N, profile="v3"),
            tdd.build_synthetic_corpus(root / "port", N, profile="v3"))


@pytest.mark.parametrize("profile", ["v1", "v2", "v3"])
def test_corpus_bytes_match_jax(profile, corpora, tmp_path):
    if profile == "v3":
        want, got = corpora
    else:
        want = jdd.build_synthetic_corpus(tmp_path / "jax", N,
                                          profile=profile)
        got = tdd.build_synthetic_corpus(tmp_path / "port", N,
                                         profile=profile)
    assert got.name == want.name == (f"synthetic-{N}" if profile == "v1"
                                     else f"synthetic-{profile}-{N}")
    assert got == tdd.corpus_dir(got.parent, N, profile)
    files = _files(want)
    assert _files(got) == files and len(files) == N + 1
    for name in files:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    assert len((got / "metadata.csv").read_text().splitlines()) == N


def test_renderers_match_jax():
    for ph in ("AA", "S", "T", "M", "IY", "SH", "SP", "SIL", "UNK"):
        for fn in ("_phoneme_signal", "_phoneme_signal_v2"):
            np.testing.assert_array_equal(
                getattr(tdd, fn)(ph, 777, 22050, 1.17),
                getattr(jdd, fn)(ph, 777, 22050, 1.17), err_msg=f"{fn} {ph}")
    import zlib

    for ph in [*jdd._VOWEL_F, *jdd._DIPHTHONG_F, *jdd._CONS, "SP", "UNK"]:
        h = zlib.crc32(ph.encode())
        assert tdd._phoneme_targets(ph, h) == jdd._phoneme_targets(ph, h), ph
    phonemes = ["HH", "AH", "L", "OW", "SP", "W", "ER", "L", "D", "CH", "Z"]
    t_rng, j_rng = np.random.default_rng(5), np.random.default_rng(5)
    for dur_s, f0 in ((0.1, 1.1), (0.083, 0.85)):
        np.testing.assert_array_equal(
            tdd._render_utterance_v3(phonemes, dur_s, 22050, f0, t_rng),
            jdd._render_utterance_v3(phonemes, dur_s, 22050, f0, j_rng))
    # both drew the same amount from their generators
    assert t_rng.integers(1 << 30) == j_rng.integers(1 << 30)


def _ljspeech_tree(root: Path) -> Path:
    from m2tts_tpu_torch.frontend.audio import save_wav

    tree = root / "LJSpeech-1.1"
    rows = []
    for i in range(5):
        fid = f"LJ001-{i:04d}"
        rows.append(f"{fid}|text {i}|text {i}\n")
        if i != 2:  # one utterance's WAV is missing
            save_wav(np.full(64, 0.1 * i, np.float32),
                     tree / "wavs" / f"{fid}.wav")
    rows.insert(3, "malformed line without fields\n")
    (tree / "metadata.csv").write_text("".join(rows))
    return tree


def test_verify_and_subset_match_jax(tmp_path, capsys):
    results = {}
    for name, mod in (("jax", jdd), ("port", tdd)):
        tree = _ljspeech_tree(tmp_path / name)
        ok = mod.verify_ljspeech(tree)
        said = capsys.readouterr().out
        sub = mod.create_ljspeech_subset(tree, 3)
        sub_said = capsys.readouterr().out.replace(str(tmp_path / name), "")
        empty = mod.verify_ljspeech(tmp_path / name / "absent")
        missing = capsys.readouterr().out.replace(str(tmp_path / name), "")
        (tree / "wavs" / "LJ001-0002.wav").write_bytes(
            (tree / "wavs" / "LJ001-0001.wav").read_bytes())
        whole = mod.verify_ljspeech(tree)
        capsys.readouterr()
        results[name] = {
            "ok": ok, "said": said, "sub": sub.relative_to(tmp_path / name),
            "sub_said": sub_said, "empty": empty, "missing": missing,
            "whole": whole,
            "meta": (sub / "metadata.csv").read_text(),
            "wavs": {p.name: p.read_bytes()
                     for p in sorted((sub / "wavs").iterdir())}}
    assert results["port"] == results["jax"]
    port = results["port"]
    assert not port["ok"] and port["whole"] and not port["empty"]
    assert "metadata entries: 5, missing wavs: 1" in port["said"]
    # the subset skips the missing WAV and the malformed line
    assert sorted(port["wavs"]) == ["LJ001-0000.wav", "LJ001-0001.wav",
                                    "LJ001-0003.wav"]


@pytest.mark.parametrize("mel_oracle", [False, True])
def test_floors_match_jax(mel_oracle, corpora, tmp_path, capsys):
    want_dir, got_dir = corpora
    args = ["--n", "2" if mel_oracle else "3", "--profile", "v3",
            "--n-mels", "80"] + (["--mel-oracle"] if mel_oracle else [])
    assert jfloors.main(["--data-dir", str(want_dir), *args, "--json",
                         str(tmp_path / "jax.json")]) == 0
    assert tfloors.main(["--data-dir", str(got_dir), *args, "--json",
                         str(tmp_path / "port.json")]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == printed
    legs = {"noise_floor", "passthrough", "lsd_noise", "lsd_passthrough",
            "oracle_f0"} | ({"mel_oracle"} if mel_oracle else set())
    assert list(got) == list(want)
    assert set(got) == legs | {"n_utterances", "corpus"}
    assert got["n_utterances"] == want["n_utterances"] == int(args[1])
    assert got["corpus"] == str(got_dir)
    for k in legs:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= FLOORS_TOL, k
    assert got["noise_floor"] < got["passthrough"] < got["oracle_f0"]


def test_global_envelope_noise_matches_jax():
    audio = np.sin(np.linspace(0.0, 40.0, 3000)) * np.linspace(0, 1, 3000)
    np.testing.assert_array_equal(
        tfloors.global_envelope_noise(audio, np.random.default_rng(3), 22050),
        jfloors.global_envelope_noise(audio, np.random.default_rng(3), 22050))


def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    assert tdd.main(["--synthetic", "2", "--synthetic-profile", "v1",
                     "--data-dir", str(tmp_path)]) == 0
    assert (tmp_path / "synthetic-2" / "metadata.csv").exists()
    # the default profile is v3, as in the JAX script
    assert tdd.main(["--synthetic", "1", "--data-dir", str(tmp_path)]) == 0
    assert (tmp_path / "synthetic-v3-1" / "wavs" / "SYN00000.wav").exists()
    # the LJSpeech download, as the JAX script's main: a failed fetch exits
    # 1; an archive already in --data-dir is extracted with no fetch (the
    # URL is a file:// path that does not exist: nothing reaches the network)
    monkeypatch.setattr(tdd, "LJSPEECH_URL",
                        (tmp_path / "absent" / "LJSpeech-1.1.tar.bz2").as_uri())
    with pytest.raises(SystemExit) as e:
        tdd.main(["--data-dir", str(tmp_path)])
    assert e.value.code == 1
    offline = tmp_path / "offline"
    _ljspeech_tree(offline / "src")
    (offline / "src" / "LJSpeech-1.1" / "wavs" / "LJ001-0002.wav").write_bytes(
        (offline / "src" / "LJSpeech-1.1" / "wavs" / "LJ001-0001.wav")
        .read_bytes())
    with tarfile.open(offline / "LJSpeech-1.1.tar.bz2", "w:bz2") as tar:
        tar.add(offline / "src" / "LJSpeech-1.1", arcname="LJSpeech-1.1")
    assert tdd.main(["--data-dir", str(offline), "--subset-size", "2"]) == 0
    assert tdd.verify_ljspeech(offline / "LJSpeech-1.1")
    assert (offline / "LJSpeech-1.1-subset-2" / "metadata.csv").exists()
    assert tdd.main(["--dataset", "vctk"]) == 0
    assert tdd.main(["--verify-only", "--data-dir", str(tmp_path)]) == 1
    _ljspeech_tree(tmp_path)
    assert tdd.main(["--verify-only", "--data-dir", str(tmp_path)]) == 1
    (tmp_path / "LJSpeech-1.1" / "wavs" / "LJ001-0002.wav").write_bytes(
        (tmp_path / "LJSpeech-1.1" / "wavs" / "LJ001-0001.wav").read_bytes())
    assert tdd.main(["--verify-only", "--subset", "2",
                     "--data-dir", str(tmp_path)]) == 0
    assert len((tmp_path / "LJSpeech-1.1-subset-2" / "metadata.csv")
               .read_text().splitlines()) == 2
    with pytest.raises(SystemExit):
        tdd.main(["--synthetic", "1", "--synthetic-profile", "v4"])
    with pytest.raises(ValueError):
        tdd.build_synthetic_corpus(tmp_path, 1, profile="v4")
