"""The port's quality drive (``m2tts_tpu_torch/evidence.py``) against
``scripts/evidence_r05.sh``: the same five steps, configs and overrides,
each run by the port's own entry points; its done-condition summary; and
the data path it drives: a corpus from the port's builder feeds the port's
``TTSDataset`` (mels within 2e-5 of the JAX ``TTSDataset``'s), which the
stage-1 trainer picks when ``data.data_dir`` names the corpus."""

import csv
import json
import shlex
from pathlib import Path

import numpy as np
import pytest
import torch

from m2tts_tpu_torch import evidence
from m2tts_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "evidence_r05.sh"
# the JAX script → the port's module
MODULES = {"scripts/download_data.py": "m2tts_tpu_torch.data.download_data",
           "scripts/corpus_floors.py":
               "m2tts_tpu_torch.evaluation.corpus_floors",
           "scripts/train.py": "m2tts_tpu_torch.training.train",
           "scripts/train_stage2.py": "m2tts_tpu_torch.training.train_stage2",
           "scripts/evaluate.py": "m2tts_tpu_torch.evaluation.evaluate"}
STEP_OF = {"scripts/download_data.py": "corpus",
           "scripts/corpus_floors.py": "corpus",
           "scripts/train.py": "stage1", "scripts/train_stage2.py": "stage2",
           "scripts/evaluate.py": "evaluate"}
MEL_TOL = 2e-5


def _script_commands(out: Path, art: Path) -> list:
    """The shell script's python and cp commands as argument lists, its
    variables replaced by the port's paths."""
    text = SCRIPT.read_text().replace("\\\n", " ")
    cmds = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(("python ", "cp ")):
            argv = shlex.split(line.replace("$OUT", str(out))
                               .replace("$ART", str(art))
                               .replace("$EARLY", "<earliest>"))
            cmds.append(argv[:argv.index(">")] if ">" in argv else argv)
    return cmds


def _split(argv: list) -> tuple:
    """(flags with their values, key=value overrides) of a command."""
    overrides = {a.split("=", 1)[0]: a.split("=", 1)[1] for a in argv
                 if "=" in a and not a.startswith("-")}
    flags = [a for a in argv if not ("=" in a and not a.startswith("-"))]
    return flags, overrides


def _plan(tmp_path, *extra):
    args = ["--out", str(tmp_path / "outputs" / "evidence_r05"),
            "--artifacts", str(tmp_path / "artifacts" / "evidence_r05"),
            "--data-dir", str(tmp_path / "data"), "--device", "cpu",
            "--dry-run", *extra]
    return args


def test_dry_run_matches_evidence_r05(tmp_path, capsys):
    out = tmp_path / "outputs" / "evidence_r05"
    art = tmp_path / "artifacts" / "evidence_r05"
    assert evidence.main(_plan(tmp_path)) == 0
    items = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    script = _script_commands(out, art)
    runs = [c for c in script if c[0] == "python"]
    copies = [c for c in script if c[0] == "cp"]
    cmds = [i for i in items if "cmd" in i]
    assert [i["step"] for i in items] == ["corpus", "corpus", "stage1",
                                          "stage2", "evaluate", "evaluate",
                                          "archive", "archive"]
    assert len(cmds) == len(runs) == 6
    corpus = str(tmp_path / "data" / "synthetic-v3-1000")
    # the port's entries take --device (the host-only corpus tools do not),
    # and its evaluations add two free-synthesis texts (the serving path)
    texts = [a for t in evidence.EVAL_TEXTS for a in ("-t", t)]
    added = {"corpus": [], "stage1": ["--device", "cpu"],
             "stage2": ["--device", "cpu"],
             "evaluate": [*texts, "--device", "cpu"]}
    for item, want in zip(cmds, runs):
        got = item["cmd"]
        assert got[1:3] == ["-m", MODULES[want[1]]]
        assert item["step"] == STEP_OF[want[1]]
        assert not any(a.endswith(".py") for a in got)
        g_flags, g_over = _split(got[3:])
        w_flags, w_over = _split(want[2:])
        # the same flags and values (the script's corpus path is the port's
        # --data-dir/synthetic-v3-<n>; its configs resolved in the repo)
        w_flags = [corpus if a == "data/synthetic-v3-1000"
                   else str(tmp_path / "data") if a == "data"
                   else str(ROOT / a) if a.startswith("configs/") else a
                   for a in w_flags]
        assert g_flags == w_flags + added[item["step"]]
        for key, value in w_over.items():
            value = corpus if value == "data/synthetic-v3-1000" else value
            assert g_over.get(key) == value, key
        extra = set(g_over) - set(w_over)
        if item["step"] == "stage2":
            # the stage-2 config names the corpus itself in the script; the
            # port passes it, so a config without it trains on the corpus
            assert extra == {"data.data_dir"}
            assert g_over["data.data_dir"] == corpus
            assert load_config(ROOT / "configs" / "stage2_xl_quality.yaml") \
                .get("data.data_dir") == "data/synthetic-v3-1000"
        else:
            assert not extra, extra
    # the corpus is built only when absent
    assert cmds[0]["if_absent"] == corpus
    assert [Path(i["copy"][1]).name for i in items if "copy" in i] == \
        [Path(c[2]).name for c in copies]
    assert [i["copy"][0] for i in items if "copy" in i] == \
        [c[1] for c in copies]
    assert [Path(i["stdout"]).name for i in cmds if "stdout" in i] == \
        ["eval_best.json", "eval_early.json"]


def test_dry_run_overrides_and_configs(tmp_path, capsys):
    assert evidence.main(_plan(
        tmp_path, "--resume", "--n", "64",
        "--stage1-config", "configs/flagship_tpu.yaml", "--stage2-config",
        str(ROOT / "configs" / "stage2_quality.yaml"),
        "--stage1-steps", "300", "--stage2-steps", "40",
        "training.learning_rate=1e-5", "training.max_loss_blowups=10")) == 0
    items = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    items = [i for i in items if i["step"] in ("stage1", "stage2")]
    assert [i["step"] for i in items] == ["stage1", "stage2"]
    for item, cfg, steps in zip(items, ("flagship_tpu", "stage2_quality"),
                                (300, 40)):
        flags, over = _split(item["cmd"][3:])
        assert "--resume" in flags
        assert Path(flags[flags.index("--config") + 1]).name == f"{cfg}.yaml"
        assert over["training.max_steps"] == str(steps)
        assert over["data.data_dir"].endswith("synthetic-v3-64")
        # the trailing overrides come last, so they win
        assert item["cmd"][-2:] == ["training.learning_rate=1e-5",
                                    "training.max_loss_blowups=10"]


def test_drive_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        evidence.main(["--dry-run"])


def _write_run(art: Path, ckpt: Path, series, best_step, best, early):
    art.mkdir(parents=True)
    with open(art / "stage2_metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["step", "total_loss", "val_utt_stoi",
                               "val_utt_lsd", "val_quality_score_audio"])
        w.writeheader()
        for step, stoi, lsd in series:
            w.writerow({"step": step, "total_loss": 1.0})
            w.writerow({"step": step, "val_utt_stoi": stoi,
                        "val_utt_lsd": lsd,
                        "val_quality_score_audio": 4 * (1 - stoi) + lsd})
    for name, (stoi, lsd) in (("best", best), ("early", early)):
        (art / f"eval_{name}.json").write_text(json.dumps({"dataset": {
            "audio_stoi": stoi, "audio_log_spectral_distance": lsd}}) + "\n")
    for step in (1000, 500, 1500):
        (ckpt / str(step)).mkdir(parents=True)
        (ckpt / str(step) / "state.pt").touch()
    (ckpt / "250").mkdir()  # no state file: not a checkpoint
    (ckpt / "best").mkdir()
    (ckpt / "best" / "score.json").write_text(json.dumps(
        {"step": best_step, "score": 1.0, "metric": "quality_score_audio"}))


def test_summary_done_condition(tmp_path):
    ckpt = tmp_path / "ckpt"
    _write_run(tmp_path / "a", ckpt, [(250, 0.25, 4.7), (500, 0.26, 4.4),
                                      (750, 0.262, 4.3)], 750,
               (0.32, 4.09), (0.29, 4.5))
    assert evidence.earliest_step(ckpt) == 500
    s = evidence.summarize(tmp_path / "a", ckpt, 500)
    assert s["held"] and all(s["done_condition"].values())
    assert [v["step"] for v in s["series"]] == [250, 500, 750]
    assert s["series"][1] == {"step": 500, "utt_stoi": 0.26, "utt_lsd": 4.4,
                              "gate": pytest.approx(4 * 0.74 + 4.4)}
    # STOI up but LSD never below the first; the gate keeps the first
    ckpt2 = tmp_path / "ckpt2"
    _write_run(tmp_path / "b", ckpt2, [(250, 0.25, 4.0), (500, 0.26, 4.4)],
               250, (0.29, 4.6), (0.30, 4.5))
    s = evidence.summarize(tmp_path / "b", ckpt2, 500)
    assert not s["held"]
    assert s["done_condition"] == {
        "later_validation_beats_first_on_both": False,
        "gate_picks_late": False, "best_beats_early_audio_stoi": False,
        "best_beats_early_audio_lsd": False}
    with pytest.raises(RuntimeError):
        evidence.earliest_step(tmp_path / "a")


def test_summary_gate_pick_before_midpoint_is_not_late(tmp_path):
    # every other leg holds, but the gate pins the second of four
    # validations: not past the run's midpoint, so the condition fails
    ckpt = tmp_path / "ckpt"
    _write_run(tmp_path / "a", ckpt, [(250, 0.25, 4.7), (500, 0.26, 4.4),
                                      (750, 0.259, 4.3), (1000, 0.258, 4.2)],
               500, (0.32, 4.09), (0.29, 4.5))
    s = evidence.summarize(tmp_path / "a", ckpt, 500)
    assert not s["held"]
    assert s["done_condition"] == {
        "later_validation_beats_first_on_both": True,
        "gate_picks_late": False, "best_beats_early_audio_stoi": True,
        "best_beats_early_audio_lsd": True}
    # one validation past the midpoint is late
    (ckpt / "best" / "score.json").write_text(json.dumps(
        {"step": 750, "score": 1.0, "metric": "quality_score_audio"}))
    assert evidence.summarize(tmp_path / "a", ckpt, 500)["held"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from m2tts_tpu_torch.data.download_data import build_synthetic_corpus

    return build_synthetic_corpus(tmp_path_factory.mktemp("data"), 4,
                                  profile="v3")


def test_port_corpus_feeds_ttsdataset_like_jax(corpus, tmp_path):
    from m2tts_tpu.data import dataset as jds
    from m2tts_tpu.frontend import audio as jaudio
    from m2tts_tpu_torch.data import dataset as tds
    from m2tts_tpu_torch.frontend import audio as taudio

    kw = dict(n_mels=80, fmax=11025.0)
    t = tds.TTSDataset(corpus, taudio.AudioProcessor(**kw), keep_audio=True,
                       cache_dir=tmp_path / "tcache")
    j = jds.TTSDataset(corpus, jaudio.AudioProcessor(**kw), keep_audio=True,
                       cache_dir=tmp_path / "jcache")
    assert len(t) == len(j) == 4
    for a, b in zip(t.samples, j.samples):
        assert a["text"] == b["text"]
        np.testing.assert_array_equal(a["phoneme_ids"], b["phoneme_ids"])
        assert (a["text_length"], a["mel_length"]) == \
            (b["text_length"], b["mel_length"])
        assert a["mel"].shape[1] == 80 and a["mel_length"] > 100
        np.testing.assert_allclose(a["mel"], b["mel"], atol=MEL_TOL, rtol=0)
        np.testing.assert_array_equal(a["audio"], b["audio"])


def test_stage1_trainer_picks_the_corpus(corpus, tmp_path):
    from m2tts_tpu_torch.data.dataset import DummyDataset, TTSDataset
    from m2tts_tpu_torch.training.trainer import Stage1Trainer
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING, Config)

    def trainer(data_dir):
        cfg = Config({"model": FLAGSHIP_MODEL, **FLAGSHIP_TRAINING})
        cfg = cfg.apply_overrides([
            f"data.data_dir={data_dir}", f"paths.output_dir={tmp_path}",
            f"paths.checkpoint_dir={tmp_path / 'ckpt'}",
            f"paths.log_dir={tmp_path / 'logs'}"])
        t = Stage1Trainer(cfg, device="cpu")
        t.close()
        return t

    t = trainer(corpus)
    assert type(t.dataset) is TTSDataset and len(t.dataset) == 4
    assert t.dataset.data_dir == Path(corpus)
    assert isinstance(trainer(tmp_path / "empty").dataset, DummyDataset)
