"""Export a deployable ``torch.export`` serving artifact.

Counterpart of ``scripts/export_model.py``. The artifact (graphs + weights
+ manifest; ``serving/export.py``) synthesizes through
``ExportedSynthesizer`` without the model's Python code.

    python -m m2tts_tpu_torch.serving.export_model --checkpoint <dir> \\
        --output exported/ [--full] [--platforms cuda,cpu] [--device cpu]
    python -m m2tts_tpu_torch.serving.export_model --random-init \\
        --output exported/   # untrained flagship artifact

``--random-init`` without ``--config`` exports the flagship model
(``FLAGSHIP_MODEL``) with seeded random weights; ``--config`` reads a YAML
config (needs PyYAML). Traces on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Export a deployable torch.export serving artifact")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--torch-checkpoint", type=str, default=None)
    p.add_argument("--random-init", action="store_true",
                   help="untrained artifact (the flagship, or --config)")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config for --random-init (default: the "
                        "flagship model)")
    p.add_argument("--output", type=str, required=True,
                   help="artifact directory to write")
    p.add_argument("--full", action="store_true",
                   help="export EVERY reachable (batch, text, frame) "
                        "bucket graph, not just the single-stream path")
    p.add_argument("--platforms", type=str, default=None,
                   help="comma-separated devices the artifact must load on "
                        "(e.g. 'cuda,cpu'); default: the --device")
    p.add_argument("--compute-dtype", type=str, default="auto",
                   choices=("auto", "bf16", "f32"))
    p.add_argument("--step", type=str, default=None,
                   help="checkpoint step to export ('best' allowed)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the graphs are traced on")
    args = p.parse_args(argv)

    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.serving.export import export_synthesizer
    from m2tts_tpu_torch.serving.synthesize import parse_step

    # the artifact's graphs run the Vocoder module (serving/export.py)
    kwargs = {"compute_dtype": args.compute_dtype, "device": args.device,
              "vocoder_backend": "torch"}
    if args.checkpoint:
        synth = pipeline.from_checkpoint(args.checkpoint,
                                         step=parse_step(args.step), **kwargs)
    elif args.torch_checkpoint:
        synth = pipeline.from_torch_checkpoint(args.torch_checkpoint,
                                               **kwargs)
    elif args.random_init:
        from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, load_config

        cfg = load_config(args.config) if args.config else FLAGSHIP_MODEL
        synth = pipeline.from_config(cfg, **kwargs)
    else:
        p.error("one of --checkpoint / --torch-checkpoint / --random-init "
                "is required")

    platforms = (tuple(s.strip() for s in args.platforms.split(","))
                 if args.platforms else None)
    manifest = export_synthesizer(synth, args.output, full=args.full,
                                  platforms=platforms)
    total = sum(f.stat().st_size
                for f in Path(args.output).rglob("*") if f.is_file())
    print(f"exported {len(manifest['graphs'])} synthesis graphs + "
          f"{len(manifest['probes'])} probes for platforms "
          f"{manifest['platforms']} -> {args.output} "
          f"({total / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
