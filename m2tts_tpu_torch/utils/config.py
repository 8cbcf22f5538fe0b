"""Config with attribute access and dotted-path overrides.

A copy of ``m2tts_tpu/utils/config.py`` for the PyTorch port. PyYAML is
imported only where YAML is read or written, so the port (and
``chip_smoke.py``, which uses ``FLAGSHIP_MODEL``) runs where PyYAML is not
installed; without it, ``apply_overrides`` parses values as JSON scalars.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Union

# The ``model:`` section of configs/flagship_tpu.yaml, kept as data so the
# flagship serving path needs no YAML parser (tests/test_torch_params.py
# holds it equal to the file).
FLAGSHIP_MODEL: Dict[str, Any] = {
    "text_encoder": {"vocab_size": 256, "hidden_dim": 96, "num_layers": 3,
                     "num_heads": 2, "dropout": 0.1, "max_seq_len": 1000},
    "duration_predictor": {"hidden_dim": 96, "kernel_size": 3,
                           "dropout": 0.1, "norm": "layer"},
    "decoder": {"hidden_dim": 96, "mel_channels": 80, "num_layers": 3},
    "vocoder": {"mel_channels": 80, "hidden_channels": 256, "kernel_size": 3,
                "upsample_rates": [8, 8, 2, 2]},
    "remat": False,
}


# The ``training:`` and ``data:`` sections of configs/flagship_tpu.yaml, so
# the training CLI trains the flagship without a YAML parser
# (tests/test_torch_params.py holds them equal to the file).
FLAGSHIP_TRAINING: Dict[str, Any] = {
    "training": {
        "batch_size": 32, "max_steps": 50000, "learning_rate": 8.0e-5,
        "warmup_steps": 2000, "lr_scheduler": "cosine",
        "gradient_clip_norm": 1.0, "bf16": True,
        "transfer_dtype": "bfloat16", "adam_b1": 0.8, "adam_b2": 0.99,
        "audio_segment_len": 8192, "adversarial_warmup_steps": 1000,
        "gate_stoi_weight": 4.0, "quality_utterances": 16,
        "adversarial_loss_weight": 0.25, "feature_matching_weight": 2.0,
        "envelope_loss_weight": 0.0, "stft_phase_weight": 0.1,
        "save_every": 2000, "validate_every": 1000, "log_every": 100,
        "seed": 1234, "device_data_cache": False,
    },
    "data": {
        "dataset_name": "ljspeech", "data_dir": "data/ljspeech",
        "sample_rate": 22050, "n_fft": 1024, "hop_length": 256,
        "win_length": 1024, "n_mels": 80, "fmin": 0, "fmax": 11025,
        "max_text_length": 256, "max_mel_length": 1000,
        "buckets": [[64, 256], [128, 512], [256, 1000]],
    },
}

# The ``model:``, ``training:`` and ``data:`` sections of
# configs/flagship_xl.yaml (384-d 6+6 layers, 512-channel vocoder).
FLAGSHIP_XL_MODEL: Dict[str, Any] = {
    "text_encoder": {"vocab_size": 256, "hidden_dim": 384, "num_layers": 6,
                     "num_heads": 6, "dropout": 0.1, "max_seq_len": 1000},
    "duration_predictor": {"hidden_dim": 384, "kernel_size": 3,
                           "dropout": 0.1, "norm": "layer"},
    "decoder": {"hidden_dim": 384, "mel_channels": 80, "num_layers": 6},
    "vocoder": {"mel_channels": 80, "hidden_channels": 512, "kernel_size": 3,
                "upsample_rates": [8, 8, 2, 2]},
    "remat": False,
}
FLAGSHIP_XL_TRAINING: Dict[str, Any] = {
    "training": {
        "batch_size": 32, "max_steps": 200000, "learning_rate": 5.0e-5,
        "warmup_steps": 4000, "lr_scheduler": "cosine",
        "gradient_clip_norm": 1.0, "bf16": True,
        "transfer_dtype": "bfloat16", "device_data_cache": True,
        "adam_b1": 0.8, "adam_b2": 0.99, "audio_segment_len": 8192,
        "save_every": 2000, "validate_every": 1000, "log_every": 100,
        "seed": 1234,
    },
    "data": FLAGSHIP_TRAINING["data"],
}

# The ``training:``, ``data:`` and ``system:`` sections of
# configs/stage2_quality.yaml (GAN training; its ``model:`` section is
# ``FLAGSHIP_MODEL``), so the stage-2 CLI trains without a YAML parser.
STAGE2_TRAINING: Dict[str, Any] = {
    "training": {
        "batch_size": 32, "gradient_accumulation_steps": 1,
        "max_steps": 50000, "learning_rate": 2.0e-5, "weight_decay": 1.0e-6,
        "warmup_steps": 300, "lr_scheduler": "cosine",
        "gradient_clip_norm": 1.0, "bf16": True, "adam_b1": 0.8,
        "adam_b2": 0.99, "mel_loss_weight": 1.0, "duration_loss_weight": 0.1,
        "adversarial_loss_weight": 0.05,
        "discriminator_spectral_norm": True,
        "feature_matching_weight": 0.5, "spectral_loss_weight": 1.0,
        "perceptual_loss_weight": 0.5, "adversarial_warmup_steps": 600,
        "gate_stoi_weight": 4.0, "quality_utterances": 16,
        "envelope_loss_weight": 4.0, "stft_phase_weight": 0.0,
        "ema_decay": 0.995, "audio_segment_len": 32768,
        "save_every": 2000, "validate_every": 1000, "max_checkpoints": 10,
        "patience": 10000, "min_delta": 0.001, "log_every": 100,
        "seed": 1234,
    },
    "data": {**FLAGSHIP_TRAINING["data"], "subset_size": None},
    "system": {
        "mesh": {"data": -1, "model": 1}, "log_metrics": "csv",
        "profile": {"start_step": 0, "num_steps": 5,
                    "log_dir": "outputs/profile"},
        "generate_samples_every": 5000,
        "eval_texts": [
            "Hello world, this is a test of the improved model.",
            "The quick brown fox jumps over the lazy dog.",
            "M2 TTS generates high quality speech synthesis.",
            "This model runs efficiently on Apple Silicon hardware."],
    },
}

# configs/stage2_xl_quality.yaml: the XL generator (its ``model:`` section
# is configs/flagship_xl.yaml's) and the stage-2 recipe with both adaptive
# guards on and the data staged on the device.
STAGE2_XL_MODEL: Dict[str, Any] = FLAGSHIP_XL_MODEL
STAGE2_XL_TRAINING: Dict[str, Any] = {
    "training": {
        **STAGE2_TRAINING["training"],
        "device_data_cache": True, "adaptive_adv_dloss_floor": 0.15,
        "adaptive_d_lr_floor": 0.15, "init_generator_from": None,
        "max_loss_blowups": 3,
    },
    "data": {**STAGE2_TRAINING["data"],
             "data_dir": "data/synthetic-v3-1000"},
    "system": {
        "mesh": {"data": -1, "model": 1}, "log_metrics": "csv",
        "generate_samples_every": 0,
        "eval_texts": STAGE2_TRAINING["system"]["eval_texts"][:2],
    },
}


def _parse_value(raw: str) -> Any:
    """An override's value: YAML when PyYAML is installed, else a JSON
    scalar or list (``true``, ``3``, ``[1, 2]``), else the string."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(raw)
        except ValueError:
            return raw
    return yaml.safe_load(raw)


class Config:
    """Nested dict with attribute access, `.get()` defaults, and YAML IO."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    @staticmethod
    def _unwrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value.to_dict()
        if isinstance(value, list):
            return [Config._unwrap(v) for v in value]
        return value

    # -- mapping / attribute protocol -------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(f"Config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = self._wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        """Dotted-path get: `cfg.get('model.text_encoder.hidden_dim', 64)`."""
        node: Any = self
        for part in key.split("."):
            if not isinstance(node, Config) or part not in node._data:
                return default
            node = node._data[part]
        return node

    def set(self, key: str, value: Any) -> None:
        """Dotted-path set, creating intermediate groups as needed."""
        parts = key.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._data or not isinstance(node._data[part], Config):
                node._data[part] = Config()
            node = node._data[part]
        node._data[parts[-1]] = self._wrap(value)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    # -- conversion --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {k: self._unwrap(v) for k, v in self._data.items()}

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def merge(self, other: Union["Config", Dict[str, Any]]) -> "Config":
        """Deep merge, `other` wins. Returns a new Config."""
        base = self.to_dict()
        over = other.to_dict() if isinstance(other, Config) else other

        def _merge(a: Dict, b: Dict) -> Dict:
            out = dict(a)
            for k, v in b.items():
                if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                    out[k] = _merge(out[k], v)
                else:
                    out[k] = v
            return out

        return Config(_merge(base, over))

    def apply_overrides(self, overrides: List[str]) -> "Config":
        """Apply `key.path=value` CLI overrides (values YAML-parsed, or
        JSON-parsed without PyYAML).

        Overrides whose key path does not already exist in the config are
        applied but WARNED about loudly — a typo'd key (`data.train_dir`
        for `data.data_dir`) otherwise silently no-ops and the run falls
        back to defaults.
        """
        import logging

        cfg = self.copy()
        for item in overrides:
            key, _, raw = item.partition("=")
            if not _:
                raise ValueError(f"Override {item!r} is not of the form key=value")
            key = key.strip()
            if not cfg.has_path(key):
                logging.getLogger(__name__).warning(
                    "Override key %r does not exist in the config file — "
                    "applying anyway, but check for a typo (known keys at "
                    "this level: %s)", key, cfg._siblings_of(key))
            value = _parse_value(raw)
            if isinstance(value, str):
                # YAML 1.1 only accepts scientific notation with a dot
                # ("3.0e-5"); a bare "3e-5" on the CLI parses as a string.
                try:
                    value = float(value)
                except ValueError:
                    pass
            cfg.set(key, value)
        return cfg

    def has_path(self, dotted: str) -> bool:
        """True if the dotted key path exists."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Config) or part not in node:
                return False
            node = node._data[part]
        return True

    def _siblings_of(self, dotted: str) -> List[str]:
        """Keys at the deepest existing level of a dotted path (for the
        typo warning)."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Config) and part in node:
                node = node._data[part]
            else:
                break
        return sorted(node.keys()) if isinstance(node, Config) else []


def load_config(path: Union[str, Path], overrides: Optional[List[str]] = None) -> Config:
    """Load a YAML config file, optionally applying key=value overrides."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    cfg = Config(data)
    if overrides:
        cfg = cfg.apply_overrides(overrides)
    return cfg


def save_config(cfg: Config, path: Union[str, Path]) -> None:
    """Write ``cfg`` as YAML (``Config.to_yaml``), making the parent
    directory."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(cfg.to_yaml())
