"""Stage-1 training CLI of the PyTorch port.

    python -m m2tts_tpu_torch.training.train [--config FILE.yaml] [--resume] \\
        [--device cuda|cpu] [key.path=value ...]

Without ``--config`` it trains the flagship (``FLAGSHIP_MODEL`` and
``FLAGSHIP_TRAINING``, no YAML parser needed), data-free when
``data.data_dir`` holds no corpus. Runs on CUDA unless ``--device cpu``.

On several devices, one process each, under torchrun, with the mesh in
``system.mesh`` (each rank on ``cuda:{LOCAL_RANK}``; rank 0 logs and
writes the checkpoints):

    torchrun --nproc-per-node 4 -m m2tts_tpu_torch.training.train \
        system.mesh.data=2 system.mesh.model=2
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

    return run(Stage1Trainer, build_config(args.config, args.overrides),
               args.device, args.resume)


def run(trainer_cls, config, device: str, resume: bool) -> int:
    """Train with ``trainer_cls`` on ``device``; under torchrun (``RANK``
    in the environment) every rank joins the process group first and
    trains its part of the mesh, and rank 0 reports."""
    import os

    import torch.distributed as dist

    from m2tts_tpu_torch.parallel.mesh import init_distributed

    if "RANK" in os.environ:
        device = init_distributed(device)
    try:
        trainer = trainer_cls(config, device=device)
        dev = trainer.device
        if not trainer.is_main:  # rank 0 reports for all
            logging.getLogger().setLevel(logging.WARNING)
        if trainer.is_main:
            logging.info("Device: %s%s%s", dev,
                         f" ({torch.cuda.get_device_name(dev)})"
                         if dev.type == "cuda" else "",
                         f", {dist.get_world_size()} ranks"
                         if dist.is_initialized() else "")
        try:
            last = trainer.train(resume=resume)
        finally:
            trainer.close()
        if trainer.is_main:
            print(f"trained to step {trainer.step}: {last}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
