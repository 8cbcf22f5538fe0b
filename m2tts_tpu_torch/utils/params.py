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
Both copy values exactly. ``optimizer_state_from_optax`` carries the
stage-1 optimizer's state across the same way, so a run of the JAX trainer
can continue in the port's.
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


def _find(node, fields: Tuple[str, ...]):
    """The first object in a nest of tuples (optax's chain and named-tuple
    states) that has every attribute in ``fields``."""
    if all(hasattr(node, f) for f in fields):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find(child, fields)
            if found is not None:
                return found
    return None


def optimizer_state_from_optax(opt_state, model: torch.nn.Module
                               ) -> Dict[str, Any]:
    """An optax state of the stage-1 optimizer (``chain(clip_by_global_norm,
    adamw)``, optionally inside ``MultiSteps``), as ``jax.device_get``
    gives it → ``training.trainer.Optimizer.state_dict()`` for ``model``:
    Adam's moments ``mu``/``nu`` and applied-update ``count``, and under
    MultiSteps the accumulated gradient and ``mini_step``. Optax's named
    tuples are found by their fields, so optax is not imported."""
    names = [n for n, _ in model.named_parameters()]
    multi = _find(opt_state, ("mini_step", "gradient_step", "acc_grads",
                              "inner_opt_state"))
    adam = _find(multi.inner_opt_state if multi is not None else opt_state,
                 ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    count = int(np.asarray(adam.count))
    mu, nu = from_flax(adam.mu), from_flax(adam.nu)
    state: Dict[str, Any] = {
        "count": count,
        "mu": {n: mu[n] for n in names} if count else {},
        "nu": {n: nu[n] for n in names} if count else {},
        "mini_step": 0, "acc_grads": None}
    if multi is not None:
        acc = from_flax(multi.acc_grads)
        state["mini_step"] = int(np.asarray(multi.mini_step))
        state["acc_grads"] = {n: acc[n] for n in names}
    return state
