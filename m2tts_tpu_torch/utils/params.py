"""Weight bridge between flax param trees and the port's state dicts.

The port's submodules carry the flax names, so a param path maps to a
state-dict key by joining it with dots and renaming the leaf. Layouts:

- Dense ``kernel (in, out)``          ↔ Linear ``weight (out, in)``
- Conv ``conv/kernel (k, in/g, out)`` ↔ Conv1d ``conv.weight (out, in/g, k)``
- ``upsample{i}/kernel (in, out, k)`` ↔ ``upsample{i}.weight``, unchanged
- LayerNorm ``scale``                 ↔ ``weight``
- Embed ``embedding/embedding``       ↔ ``embedding.weight``
- ``bias`` and ConvBlock ``bn_*``     ↔ the same names

``from_flax`` takes the nested dict of numpy arrays that
``jax.device_get(params)`` gives (with or without the top ``"params"``
level); ``to_flax`` returns ``{"params": ...}`` as ``model.init`` does.
Both copy values exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree → state dict of CPU tensors."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        a = np.array(leaf)  # own copy: torch.from_numpy shares memory
        *mods, name = path
        if name == "kernel":
            if a.ndim == 2:            # Dense
                a = a.T
            elif mods[-1:] == ["conv"]:  # Conv (k, in/g, out) → (out, in/g, k)
                a = a.transpose(2, 1, 0)
            # transposed conv: (in, out, k) in both
            name = "weight"
        elif name == "scale" or (name == "embedding"
                                   and mods[-1:] == ["embedding"]):
            name = "weight"
        sd[".".join(mods + [name])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return sd


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """State dict → ``{"params": nested dict of numpy arrays}``."""
    root: Dict[str, Any] = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy().copy()
        *mods, name = key.split(".")
        if name == "weight":
            if mods[-1:] == ["embedding"] and a.ndim == 2:
                name = "embedding"
            elif a.ndim == 1:          # LayerNorm
                name = "scale"
            elif a.ndim == 2:          # Linear
                a, name = a.T, "kernel"
            elif mods[-1:] == ["conv"]:  # Conv1d
                a, name = a.transpose(2, 1, 0), "kernel"
            else:                      # transposed conv
                name = "kernel"
        node = root
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return {"params": root}
