"""Checkpoint evaluation CLI of the PyTorch port: quality metrics over a
dataset and free synthesis of evaluation texts.

Counterpart of ``scripts/evaluate.py``:

  --data-dir     teacher-forced metrics over a dataset (mel L1/L2,
                 spectral convergence, LSD, MCD, duration accuracy);
                 ``--audio-metrics`` adds STOI, spectral convergence and
                 LSD of the teacher-forced waveforms against the recordings
  --texts/-t     free synthesis of eval sentences with the heuristic MOS
                 estimate and optional WAV dumps

    python -m m2tts_tpu_torch.evaluation.evaluate --checkpoint <dir> \\
        --data-dir data/LJSpeech-1.1-subset-100 --num-samples 64
    python -m m2tts_tpu_torch.evaluation.evaluate --checkpoint <dir> \\
        -t "Hello world." -t "A second sentence." --dump-wavs out/eval

The dataset's mel settings and buckets come from the checkpoint's config,
so evaluation features match training's. Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="m2tts evaluation (PyTorch/CUDA port)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--step", type=str, default=None,
                   help="checkpoint step: int, 'best', or latest")
    p.add_argument("--torch-checkpoint", type=str, default=None)
    p.add_argument("--data-dir", type=str, default=None,
                   help="dataset for teacher-forced metrics")
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--audio-metrics", action="store_true",
                   help="with --data-dir: also synthesize teacher-forced "
                        "waveforms and score STOI / spectral convergence / "
                        "LSD against the ground-truth recordings")
    p.add_argument("--texts", "-t", action="append", default=[],
                   help="eval sentences (repeatable)")
    p.add_argument("--dump-wavs", type=str, default=None,
                   help="directory for synthesized eval-text WAVs")
    p.add_argument("--duration-scale", type=float, default=1.0)
    p.add_argument("--json", action="store_true",
                   help="print one JSON object instead of a report")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if not args.checkpoint and not args.torch_checkpoint:
        p.error("one of --checkpoint / --torch-checkpoint is required")
    if not args.data_dir and not args.texts:
        p.error("nothing to do: pass --data-dir and/or --texts")

    from m2tts_tpu_torch.evaluation.metrics import (TTSEvaluator,
                                                    benchmark_model_performance,
                                                    estimate_mos_score)
    from m2tts_tpu_torch.frontend.audio import save_wav
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.serving.synthesize import parse_step

    synth = (pipeline.from_checkpoint(args.checkpoint,
                                      step=parse_step(args.step),
                                      device=args.device)
             if args.checkpoint
             else pipeline.from_torch_checkpoint(args.torch_checkpoint,
                                                 device=args.device))
    report = {}

    if args.data_dir:
        from m2tts_tpu_torch.data.dataset import TTSDataset, make_batches
        from m2tts_tpu_torch.frontend.audio import AudioProcessor

        # the dataset's mel settings must match the checkpoint's model
        # (n_mels etc.), not the AudioProcessor defaults
        ap = AudioProcessor.from_config(
            synth.config.get("data") if synth.config else None)
        ds = TTSDataset(args.data_dir, audio_processor=ap,
                        keep_audio=args.audio_metrics)
        # the checkpoint's buckets: evaluation runs the shapes training ran
        buckets = [tuple(b) for b in (
            synth.config.get("data.buckets") if synth.config else None
        ) or [(64, 256), (128, 512), (256, 1000)]]
        params = synth.model.state_dict()
        batches = make_batches(ds, args.batch_size, buckets=buckets,
                               seed=0, shuffle=False, drop_last=False)
        metrics = benchmark_model_performance(
            synth.model, params, batches,
            num_samples=args.num_samples, sample_rate=synth.sample_rate)
        report["dataset"] = {k: round(float(v), 5)
                             for k, v in metrics.items()}
        if args.audio_metrics:
            from m2tts_tpu_torch.evaluation.metrics import \
                benchmark_audio_quality

            audio_batches = make_batches(
                ds, args.batch_size, buckets=buckets, seed=0, shuffle=False,
                drop_last=False,
                audio_samples=max(m for _, m in buckets) * synth.hop_length)
            audio_metrics = benchmark_audio_quality(
                synth.model, params, audio_batches,
                num_samples=args.num_samples, sample_rate=synth.sample_rate,
                hop_length=synth.hop_length)
            report["dataset"].update({f"audio_{k}": round(float(v), 5)
                                      for k, v in audio_metrics.items()})

    if args.texts:
        results = synth.synthesize_batch(args.texts, args.duration_scale)
        per_text = []
        for text, r in zip(args.texts, results):
            audio = np.asarray(r["audio"], np.float32)
            mos = float(estimate_mos_score(
                audio, sample_rate=synth.sample_rate)["estimated_mos"])
            item = {"text": text,
                    "seconds": round(len(audio) / synth.sample_rate, 3),
                    "estimated_mos": round(mos, 3)}
            if args.dump_wavs:
                out = Path(args.dump_wavs)
                out.mkdir(parents=True, exist_ok=True)
                path = out / f"eval_{len(per_text):03d}.wav"
                save_wav(audio, path, synth.sample_rate)
                item["wav"] = str(path)
            per_text.append(item)
        report["texts"] = per_text
        report["estimated_mos_mean"] = round(
            float(np.mean([t["estimated_mos"] for t in per_text])), 3)

    if args.json:
        print(json.dumps(report))
    else:
        if "dataset" in report:
            print("== dataset metrics ==")
            print(TTSEvaluator(synth.sample_rate)
                  .generate_evaluation_report(report["dataset"]))
        for t in report.get("texts", []):
            print(f"  MOS~{t['estimated_mos']:.2f}  {t['seconds']:6.2f}s  "
                  f"{t['text'][:60]!r}" + (f"  -> {t['wav']}" if "wav" in t
                                           else ""))
        if "estimated_mos_mean" in report:
            print(f"mean estimated MOS: {report['estimated_mos_mean']:.3f} "
                  f"(heuristic, not a human MOS)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
