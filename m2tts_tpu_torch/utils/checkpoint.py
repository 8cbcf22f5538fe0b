"""Self-describing checkpoints with rotation, in a torch-native format.

Counterpart of ``m2tts_tpu/utils/checkpoint.py``. Each checkpoint is a
directory ``<dir>/<step>/`` holding ``state.pt`` (``torch.save`` of the
state: nested dicts and lists of tensors and plain values, read back with
``torch.load(weights_only=True)``), ``config.json`` (the full config, so a
checkpoint alone rebuilds the model) and ``metrics.json`` when metrics were
given. Rotation keeps the newest ``max_to_keep``. A checkpoint is written
under a temporary name and renamed into place, so a reader never sees a
half-written step.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from m2tts_tpu_torch.utils.config import Config

STATE_FILE = "state.pt"
CONFIG_FILE = "config.json"
METRICS_FILE = "metrics.json"


class CheckpointManager:
    """State + config JSON per step under one directory, newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: Union[str, Path], max_to_keep: int = 5):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def save(self, step: int, state: Any,
             config: Union[Config, Dict, None] = None,
             metrics: Optional[Dict[str, float]] = None) -> None:
        step = int(step)
        final = self.directory / str(step)
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / STATE_FILE)
        if config is not None:
            cfg = config.to_dict() if isinstance(config, Config) else dict(config)
            (tmp / CONFIG_FILE).write_text(json.dumps(cfg))
        if metrics is not None:
            (tmp / METRICS_FILE).write_text(
                json.dumps({k: float(v) for k, v in metrics.items()}))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def restore(self, step: Optional[int] = None
                ) -> Tuple[Any, Optional[Config], int]:
        """(state, config or None, step); the latest step when ``step`` is
        None. Tensors load on the CPU."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"No checkpoints in {self.directory}")
        d = self.directory / str(int(step))
        if not (d / STATE_FILE).exists():
            raise FileNotFoundError(f"No checkpoint for step {step} in "
                                    f"{self.directory}")
        state = torch.load(d / STATE_FILE, map_location="cpu",
                           weights_only=True)
        config = (Config(json.loads((d / CONFIG_FILE).read_text()))
                  if (d / CONFIG_FILE).exists() else None)
        return state, config, int(step)

    def state_keys(self, step: Optional[int] = None) -> Optional[List[str]]:
        """Top-level keys of the stored state of ``step`` (the latest when
        None), or None when there is no such checkpoint or its file cannot
        be read that way. The file is memory-mapped, so no tensor is read
        into memory."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        try:
            state = torch.load(self.directory / str(int(step)) / STATE_FILE,
                               map_location="cpu", weights_only=True,
                               mmap=True)
        except Exception:  # unreadable for any reason: the caller decides
            return None
        return list(state) if isinstance(state, dict) else None

    def all_steps(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The latest step, as the JAX package's manager answers when no
        ``best_fn`` ranks its checkpoints (none of its callers sets one);
        the best-validation checkpoint is pinned under ``<dir>/best``."""
        return self.latest_step()

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's
        interface."""


def load_for_inference(directory: Union[str, Path],
                       step: Union[int, str, None] = None
                       ) -> Tuple[Dict[str, torch.Tensor], Config, int]:
    """Checkpoint dir → (state dict of the port's ``M2TTS``, config, step).

    Extracts the generator weights whatever the train-state layout:
    ``generator_ema`` when the trainer kept an EMA, then ``generator`` or
    ``params``. ``step="best"`` loads the best-validation checkpoint
    pinned under ``<dir>/best``. A checkpoint without a config raises
    ``ValueError``.
    """
    directory = Path(directory)
    if step == "best":
        best_dir = directory / "best"
        if not best_dir.exists():
            raise FileNotFoundError(
                f"No best-checkpoint dir at {best_dir}; train with "
                "validation enabled to produce one")
        directory, step = best_dir, None
    if not directory.is_dir():
        raise FileNotFoundError(f"No checkpoint directory at {directory}")
    state, config, step = CheckpointManager(directory).restore(step)
    if config is None:
        raise ValueError(f"Checkpoint at {directory} has no embedded config")
    params = state
    if isinstance(params, dict) and "generator_ema" in params:
        params = params["generator_ema"]
    for key in ("generator", "params"):
        if isinstance(params, dict) and key in params:
            params = params[key]
    return params, config, step
