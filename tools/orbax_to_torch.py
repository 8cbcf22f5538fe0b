#!/usr/bin/env python
"""Convert a checkpoint directory of the JAX package (orbax) into the
PyTorch port's format.

    python tools/orbax_to_torch.py <orbax checkpoint dir> <output dir>

Reads every step with ``m2tts_tpu.utils.checkpoint.CheckpointManager``,
and the best-validation pin under ``<dir>/best`` with its ``score.json``,
and writes ``<output>/<step>/state.pt`` + ``config.json`` (and
``<output>/best/...``) with the port's ``CheckpointManager``, which
``m2tts_tpu_torch`` trains, resumes and serves from. Both trainers'
payloads are converted:

- stage 1: ``params``, ``opt_state``, ``step``;
- stage 2: ``generator``, ``g_opt_state``, ``discriminator``,
  ``d_opt_state``, ``step`` and, when the run kept one, ``generator_ema``.

Weights go through ``m2tts_tpu_torch.utils.params.from_flax`` and optax
states through ``optimizer_state_from_optax``, which copy values exactly.
The tool imports both packages, so it runs where jax and orbax are
installed; the port itself never imports it.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path
from typing import Any, Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PARAM_KEYS = ("params", "generator", "generator_ema", "discriminator")
OPT_KEYS = {"opt_state": "generator", "g_opt_state": "generator",
            "d_opt_state": "discriminator"}


def convert_state(state: Dict[str, Any], config) -> Dict[str, Any]:
    """One restored orbax train state → the port's state dict layout;
    ``config`` (the checkpoint's) sizes the modules whose parameter names
    key the optimizer moments. Raises on a key of neither payload."""
    from m2tts_tpu_torch.models.discriminator import MultiScaleDiscriminator
    from m2tts_tpu_torch.models.tts_model import build_model
    from m2tts_tpu_torch.utils.config import Config
    from m2tts_tpu_torch.utils.params import (from_flax,
                                              optimizer_state_from_optax)

    unknown = set(state) - set(PARAM_KEYS) - set(OPT_KEYS) - {"step"}
    if unknown:
        raise ValueError(f"unknown train-state keys {sorted(unknown)}")
    cfg = Config(config.to_dict() if config is not None else {})
    modules = {"generator": build_model(cfg.get("model", Config()))}
    if "discriminator" in state:
        modules["discriminator"] = MultiScaleDiscriminator()
    out: Dict[str, Any] = {}
    for key, value in state.items():
        if key in PARAM_KEYS:
            out[key] = from_flax(value)
        elif key in OPT_KEYS:
            out[key] = optimizer_state_from_optax(value,
                                                  modules[OPT_KEYS[key]])
        else:
            out[key] = int(value)
    return out


def _convert_dir(src: Path, dst: Path) -> List[int]:
    from m2tts_tpu.utils.checkpoint import CheckpointManager as OrbaxManager
    from m2tts_tpu_torch.utils.checkpoint import CheckpointManager

    reader = OrbaxManager(src)
    try:
        steps = reader.all_steps()
        writer = CheckpointManager(dst, max_to_keep=max(1, len(steps)))
        for step in steps:
            state, config, _ = reader.restore(step)
            writer.save(step, convert_state(state, config),
                        config=config.to_dict() if config else None)
    finally:
        reader.close()
    return steps


def convert(src, dst) -> Dict[str, List[int]]:
    """Convert every step of ``src`` and its ``best/`` pin into ``dst``;
    returns the steps converted, by directory."""
    src, dst = Path(src), Path(dst)
    if not src.is_dir():
        raise FileNotFoundError(f"No checkpoint directory at {src}")
    done = {"steps": _convert_dir(src, dst)}
    if (src / "best").is_dir():
        done["best"] = _convert_dir(src / "best", dst / "best")
        score = src / "best" / "score.json"
        if score.exists():
            shutil.copyfile(score, dst / "best" / "score.json")
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert a JAX (orbax) checkpoint dir to the PyTorch "
                    "port's format")
    p.add_argument("src", help="checkpoint dir written by the JAX package")
    p.add_argument("dst", help="output dir (utils/checkpoint.py format)")
    args = p.parse_args(argv)
    done = convert(args.src, args.dst)
    print(f"converted steps {done['steps']}"
          + (f" and best {done['best']}" if "best" in done else "")
          + f" -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
