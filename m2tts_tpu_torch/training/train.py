"""Stage-1 training CLI of the PyTorch port.

    python -m m2tts_tpu_torch.training.train [--config FILE.yaml] [--resume] \\
        [--device cuda|cpu] [key.path=value ...]

Without ``--config`` it trains the flagship (``FLAGSHIP_MODEL`` and
``FLAGSHIP_TRAINING``, no YAML parser needed), data-free when
``data.data_dir`` holds no corpus. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch


def build_config(config_path=None, overrides=()):
    from m2tts_tpu_torch.utils.config import (FLAGSHIP_MODEL,
                                              FLAGSHIP_TRAINING, Config,
                                              load_config)

    if config_path:
        return load_config(config_path, overrides=list(overrides))
    cfg = Config({"model": FLAGSHIP_MODEL, **FLAGSHIP_TRAINING})
    return cfg.apply_overrides(list(overrides)) if overrides else cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="m2tts stage-1 training (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (default: the flagship)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from m2tts_tpu_torch.training.trainer import Stage1Trainer

    config = build_config(args.config, args.overrides)
    trainer = Stage1Trainer(config, device=args.device)
    dev = trainer.device
    logging.info("Device: %s%s", dev, f" ({torch.cuda.get_device_name(dev)})"
                 if dev.type == "cuda" else "")
    try:
        trainer.train(resume=args.resume)
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
