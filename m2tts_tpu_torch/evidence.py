"""Quality evidence drive of the PyTorch port: does stage-2 GAN training
improve the audio of a model trained on a synthetic speech-like corpus?

The port's counterpart of ``scripts/evidence_r05.sh``, five steps, each a
subprocess of the port's own entry points:

  1. corpus    build ``<data-dir>/synthetic-v3-<n>`` with
               ``data.download_data`` (only if it is absent), then measure
               its STOI floors with ``evaluation.corpus_floors`` (n = 16)
  2. stage1    ``training.train`` on the corpus (device data cache,
               ``validate_every`` 1000, ``save_every`` 2000)
  3. stage2    ``training.train_stage2`` warm-started from stage 1
               (``validate_every`` 250, ``quality_utterances`` 16)
  4. evaluate  ``evaluation.evaluate --audio-metrics --json`` on stage 2's
               ``best`` checkpoint and on its earliest one
  5. archive   both runs' ``metrics.csv``, and ``summary.json``: the
               validation series and the done condition (a later validation
               beats the first on both utt_STOI and utt_LSD, the gate pins a
               checkpoint past the run's midpoint, and ``best`` beats the
               earliest checkpoint on audio STOI and LSD)

    python -m m2tts_tpu_torch.evidence --out outputs/evidence \\
        --stage1-config configs/flagship_tpu.yaml \\
        --stage2-config configs/stage2_quality.yaml

Trailing ``key=value`` overrides go to both trainers. ``--resume``
continues both trainers from their latest checkpoints (a finished stage 1
restores and stops at once; the corpus is built only when absent);
``--dry-run`` prints the commands, one JSON object a line, and runs
nothing. Runs on CUDA unless ``--device cpu``; relative
paths are taken from the current directory.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROFILE = "v3"
FLOOR_UTTERANCES = 16
EVAL_SAMPLES = 64
# free synthesis of two sentences in each evaluation: the serving path
# (the checkpoint through the Synthesizer's vocoder backend)
EVAL_TEXTS = ("The quick brown fox jumps over the lazy dog.",
              "Speech synthesis research moved ahead on fast models.")


def _module(name: str, *args) -> list:
    return [sys.executable, "-m", f"m2tts_tpu_torch.{name}", *map(str, args)]


def _paths(run_dir: Path) -> list:
    return [f"paths.output_dir={run_dir}",
            f"paths.checkpoint_dir={run_dir / 'ckpt'}",
            f"paths.log_dir={run_dir / 'logs'}"]


def plan(args, early="<earliest>") -> list:
    """The drive's commands as ``{"step", "cmd"}`` (``stdout`` when the
    command's output is kept, ``if_absent`` when it runs only without that
    path) and its copies as ``{"step", "copy": [src, dst]}``, in order.
    ``early`` is stage 2's earliest checkpoint step, known once it ran."""
    out, art = Path(args.out), Path(args.artifacts)
    corpus = Path(args.data_dir) / f"synthetic-{PROFILE}-{args.n}"
    dev = ["--device", args.device]
    resume = ["--resume"] if args.resume else []
    s1, s2 = out / "stage1", out / "stage2"
    evaluate = ["--data-dir", corpus, "--num-samples", EVAL_SAMPLES,
                "--audio-metrics", "--json"]
    for text in EVAL_TEXTS:
        evaluate += ["-t", text]
    return [
        {"step": "corpus", "if_absent": str(corpus),
         "cmd": _module("data.download_data", "--synthetic", args.n,
                        "--data-dir", args.data_dir,
                        "--synthetic-profile", PROFILE)},
        {"step": "corpus",
         "cmd": _module("evaluation.corpus_floors", "--data-dir", corpus,
                        "--n", FLOOR_UTTERANCES, "--profile", PROFILE,
                        "--json", art / "corpus_floors.json")},
        {"step": "stage1",
         "cmd": _module("training.train", "--config", args.stage1_config,
                        *dev, *resume, f"data.data_dir={corpus}",
                        f"training.max_steps={args.stage1_steps}",
                        "training.device_data_cache=true",
                        "training.validate_every=1000",
                        "training.save_every=2000",
                        "training.log_every=200", *_paths(s1),
                        *args.overrides)},
        {"step": "stage2",
         "cmd": _module("training.train_stage2", "--config",
                        args.stage2_config, *dev, *resume,
                        f"data.data_dir={corpus}",
                        f"training.max_steps={args.stage2_steps}",
                        "training.validate_every=250",
                        "training.save_every=500",
                        "training.log_every=100",
                        "training.quality_utterances=16",
                        f"training.init_generator_from={s1 / 'ckpt'}",
                        *_paths(s2), *args.overrides)},
        {"step": "evaluate", "stdout": str(art / "eval_best.json"),
         "cmd": _module("evaluation.evaluate", "--checkpoint", s2 / "ckpt",
                        "--step", "best", *evaluate, *dev)},
        {"step": "evaluate", "stdout": str(art / "eval_early.json"),
         "cmd": _module("evaluation.evaluate", "--checkpoint", s2 / "ckpt",
                        "--step", early, *evaluate, *dev)},
        {"step": "archive", "copy": [str(s1 / "logs" / "metrics.csv"),
                                     str(art / "stage1_metrics.csv")]},
        {"step": "archive", "copy": [str(s2 / "logs" / "metrics.csv"),
                                     str(art / "stage2_metrics.csv")]},
    ]


def earliest_step(ckpt_dir: Path) -> int:
    """The earliest checkpoint step saved under ``ckpt_dir``."""
    from m2tts_tpu_torch.utils.checkpoint import CheckpointManager

    steps = CheckpointManager(ckpt_dir).all_steps()
    if not steps:
        raise RuntimeError(f"no numbered checkpoint under {ckpt_dir}")
    return steps[0]


def _series(path: Path) -> list:
    """Stage 2's validations from its metrics.csv: step, utt_STOI, utt_LSD
    and the gate's score, in order."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [{"step": int(r["step"]), "utt_stoi": float(r["val_utt_stoi"]),
             "utt_lsd": float(r["val_utt_lsd"]),
             "gate": float(r["val_quality_score_audio"])}
            for r in rows if r.get("val_utt_stoi")]


def summarize(art: Path, ckpt_dir: Path, early: int) -> dict:
    """The validation series, the gate's pick and the evaluation of best
    against the earliest checkpoint, each leg of the done condition a
    boolean."""
    series = _series(art / "stage2_metrics.csv")
    best = json.loads((Path(ckpt_dir) / "best" / "score.json").read_text())
    ev = {k: json.loads((art / f"eval_{k}.json").read_text()
                        .strip().splitlines()[-1])["dataset"]
          for k in ("best", "early")}
    first = series[0]
    cond = {
        "later_validation_beats_first_on_both": any(
            v["utt_stoi"] > first["utt_stoi"] and v["utt_lsd"] < first["utt_lsd"]
            for v in series[1:]),
        # late as round 5 read it (step 5,000 of 8,000): past the midpoint
        # of the run, whose end is its last validation
        "gate_picks_late": best["step"] > series[-1]["step"] / 2,
        "best_beats_early_audio_stoi": ev["best"]["audio_stoi"]
        > ev["early"]["audio_stoi"],
        "best_beats_early_audio_lsd": ev["best"]["audio_log_spectral_distance"]
        < ev["early"]["audio_log_spectral_distance"],
    }
    return {"series": series, "best": best, "early_step": early,
            "eval": ev, "done_condition": cond,
            "held": all(cond.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Quality evidence drive (PyTorch/CUDA port)")
    p.add_argument("--out", default="outputs/evidence_torch",
                   help="training runs (stage1/, stage2/)")
    p.add_argument("--artifacts", default="outputs/evidence_torch/artifacts",
                   help="floors, evaluations, metrics copies, summary")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--n", type=int, default=1000,
                   help="utterances of the v3 corpus")
    p.add_argument("--stage1-config",
                   default=str(ROOT / "configs" / "flagship_xl.yaml"))
    p.add_argument("--stage2-config",
                   default=str(ROOT / "configs" / "stage2_xl_quality.yaml"))
    p.add_argument("--stage1-steps", type=int, default=6000)
    p.add_argument("--stage2-steps", type=int, default=4000)
    p.add_argument("--resume", action="store_true",
                   help="resume both trainers from their latest checkpoint")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dry-run", action="store_true",
                   help="print the commands and run nothing")
    p.add_argument("overrides", nargs="*",
                   help="key.path=value overrides for both trainers")
    args = p.parse_args(argv)
    for key in ("out", "artifacts", "data_dir", "stage1_config",
                "stage2_config"):
        setattr(args, key, str(Path(getattr(args, key)).resolve()))

    from m2tts_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    if args.dry_run:
        for item in plan(args):
            print(json.dumps(item))
        return 0

    art = Path(args.artifacts)
    art.mkdir(parents=True, exist_ok=True)
    ckpt = Path(args.out) / "stage2" / "ckpt"
    early, items = None, plan(args)
    for i in range(len(items)):
        if items[i]["step"] == "evaluate" and early is None:
            early = earliest_step(ckpt)
            items = plan(args, early)
        item = items[i]
        if "copy" in item:
            shutil.copyfile(*item["copy"])
            continue
        if "if_absent" in item and Path(item["if_absent"]).exists():
            continue
        print(f"evidence: {item['step']}: {' '.join(item['cmd'])}",
              flush=True)
        t0 = time.perf_counter()
        if "stdout" in item:
            with open(item["stdout"], "w") as f:
                subprocess.run(item["cmd"], cwd=ROOT, check=True, stdout=f)
        else:
            subprocess.run(item["cmd"], cwd=ROOT, check=True)
        print(f"evidence: {item['step']}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    summary = summarize(art, ckpt, early)
    (art / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"done_condition": summary["done_condition"],
                      "held": summary["held"]}))
    print(f"evidence drive complete -> {art}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
