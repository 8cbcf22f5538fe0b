"""Stage-2 (GAN) training CLI of the PyTorch port.

    python -m m2tts_tpu_torch.training.train_stage2 [--config FILE.yaml] \\
        [--resume] [--device cuda|cpu] [key.path=value ...]

Without ``--config`` it trains the flagship generator (``FLAGSHIP_MODEL``)
with configs/stage2_quality.yaml's recipe (``STAGE2_TRAINING``, no YAML
parser needed), data-free when ``data.data_dir`` holds no corpus. Warm-start
the generator from a stage-1 checkpoint with
``training.init_generator_from=<checkpoint dir>``. Runs on CUDA unless
``--device cpu``; on several devices under torchrun, as
``training/train.py`` says:

    torchrun --nproc-per-node 2 -m m2tts_tpu_torch.training.train_stage2 \
        system.mesh.data=2
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_config(config_path=None, overrides=()):
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL, STAGE2_TRAINING,
                                              Config, load_config)

    if config_path:
        return load_config(config_path, overrides=list(overrides))
    cfg = Config({"model": FLAGSHIP_MODEL, **STAGE2_TRAINING})
    return cfg.apply_overrides(list(overrides)) if overrides else cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="m2tts stage-2 GAN training (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (default: the flagship with the "
                        "stage-2 quality recipe)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from m2tts_tpu_torch.training.train import run
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer

    return run(Stage2Trainer, build_config(args.config, args.overrides),
               args.device, args.resume)


if __name__ == "__main__":
    sys.exit(main())
