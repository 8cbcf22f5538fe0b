"""Config with attribute access and dotted-path overrides.

A copy of ``m2tts_tpu/utils/config.py`` for the PyTorch port. PyYAML is
imported only where YAML is read or written, so the port (and
``chip_smoke.py``, which uses ``FLAGSHIP_MODEL``) runs where PyYAML is not
installed.
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
        """Apply `key.path=value` CLI overrides (values YAML-parsed).

        Overrides whose key path does not already exist in the config are
        applied but WARNED about loudly — a typo'd key (`data.train_dir`
        for `data.data_dir`) otherwise silently no-ops and the run falls
        back to defaults.
        """
        import logging

        import yaml

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
            value = yaml.safe_load(raw)
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
