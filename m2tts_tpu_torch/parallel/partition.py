"""Tensor-parallel placement over the mesh's 'model' axis.

Counterpart of ``m2tts_tpu/parallel/partition.py``: Megatron's layout for
the transformer blocks, as rules on parameter paths. The port's paths are
the flax ones (``text_encoder.layer0.attn.qkv.weight``), but a torch
``nn.Linear`` stores ``[out, in]`` where flax stores ``[in, out]``, so the
JAX column split ``P(None, 'model')`` is ``Shard(0)`` here and the row
split ``P('model', None)`` is ``Shard(1)``.

The fused QKV weight ``[3·hidden, hidden]`` (features laid out ``(3,
heads, head_dim)``) is placed as its ``(3, hidden, hidden)`` view with
``Shard(1)``: each rank holds whole heads of q, k and v. A contiguous
``Shard(0)`` of the fused rows would hand one rank all of q and half of k,
and the attention's per-head reshape could not be split. The output
projection's ``Shard(1)`` splits its input features, which are the same
heads, so each rank's attention ends in a partial sum over its heads
(``reduce_from_model``). The FFN is the column/row pair.

Everything else is replicated, and on a 'model' axis of one every rule
degenerates to replication, as in JAX, so a (d, 1) mesh runs the plain
modules. Checkpoints, ``from_flax`` and export keep the global flax
layout: ``shard_tree``/``shard_module`` place it (``distribute_tensor``
on every rank's copy, no collective) and ``full_tree`` gathers it back.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from m2tts_tpu_torch.parallel.mesh import batch_sharding, local

#: (path regex, placement): first match wins; the default is replicated
TP_RULES: List[Tuple[str, Placement]] = [
    (r"attn.*qkv.*weight", Shard(1)),  # heads, on the (3, H, H) view
    (r"attn.*out.*weight", Shard(1)),  # row: partial sums over heads
    (r"ffn.*fc1.*weight", Shard(0)),   # column
    (r"ffn.*fc1.*bias", Shard(0)),
    (r"ffn.*fc2.*weight", Shard(1)),   # row
]
_QKV = re.compile(TP_RULES[0][0])


def spec_for_path(path: str) -> Placement:
    for pattern, spec in TP_RULES:
        if re.search(pattern, path):
            return spec
    return Replicate()


def _map(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _view_shape(path: str, shape) -> Tuple[int, ...]:
    """The shape a leaf is placed in: the fused QKV weight as (3, H, H)."""
    shape = tuple(shape)
    if _QKV.search(path) and len(shape) == 2:
        return (3, shape[0] // 3, shape[1])
    return shape


def partition_specs(tree: Any) -> Any:
    """The nest of placements mirroring ``tree`` (params or grads)."""
    return _map(tree, lambda path, _: spec_for_path(path))


def _placement(path: str, leaf, split: bool) -> Placement:
    spec = spec_for_path(path)
    if not (split and isinstance(leaf, torch.Tensor)
            and isinstance(spec, Shard)
            and spec.dim < len(_view_shape(path, leaf.shape))):
        return Replicate()
    return spec


def tree_shardings(tree: Any, mesh) -> Any:
    """The placement of each tensor of ``tree`` on ``mesh['model']``: the
    rules where they match and the axis is above one, ``Replicate()``
    elsewhere (optimizer scalars and counters, ranks the rule does not
    fit)."""
    split = mesh["model"].size() > 1
    return _map(tree, lambda path, leaf: _placement(path, leaf, split))


def _place(path: str, t: torch.Tensor, spec, mesh):
    """This rank's DTensor of the global tensor ``t`` under ``spec`` (no
    collective: every rank holds ``t``)."""
    x = t.reshape(_view_shape(path, t.shape)) if spec.is_shard() else t
    n = mesh["model"].size()
    if spec.is_shard() and x.shape[spec.dim] % n:
        raise ValueError(f"{path}: dim {spec.dim} of {tuple(x.shape)} does "
                         f"not split over model={n}")
    return distribute_tensor(x, mesh["model"], [spec], src_data_rank=None)


def shard_tree(tree: Any, mesh) -> Any:
    """DTensors on ``mesh['model']`` of every tensor of a nest of global
    tensors (TP rules where they match, replicated elsewhere); other leaves
    pass through."""
    split = mesh["model"].size() > 1
    return _map(tree, lambda path, leaf: _place(
        path, leaf, _placement(path, leaf, split), mesh)
        if isinstance(leaf, torch.Tensor) else leaf)


def shard_like(full: torch.Tensor, like) -> torch.Tensor:
    """The global tensor ``full`` placed as the DTensor ``like`` is (its
    mesh, placements, global shape, device and dtype)."""
    return distribute_tensor(full.to(like.device, like.dtype).reshape(
        like.shape), like.device_mesh, like.placements, src_data_rank=None)


def _gather(path: str, t: torch.Tensor) -> torch.Tensor:
    """The global tensor of a DTensor, by ``dist.all_gather`` over each
    sharded mesh dim: ``DTensor.full_tensor()`` goes through the functional
    collectives, which crash the process on CUDA tensors under gloo (torch
    2.11, two ranks sharing one card)."""
    if not isinstance(t, DTensor):
        return t
    x = t.to_local().detach()
    for mesh_dim, spec in enumerate(t.placements):
        if spec.is_shard():
            parts = [torch.empty_like(x)
                     for _ in range(t.device_mesh.size(mesh_dim))]
            dist.all_gather(parts, x.contiguous(),
                            group=t.device_mesh.get_group(mesh_dim))
            x = torch.cat(parts, dim=spec.dim)
    return x.reshape(-1, x.shape[-1]) if _QKV.search(path) and x.dim() == 3 \
        else x


def full_tree(tree: Any) -> Any:
    """Every DTensor of a nest of dicts gathered to the plain global tensor
    in the flax layout (a collective: every rank calls it, in the same
    order); other leaves pass through."""
    return _map(tree, _gather)


def local_tree(tree: Any) -> Any:
    """Every DTensor of a nest of dicts as its local tensor."""
    return _map(tree, lambda _, leaf: local(leaf)
                if isinstance(leaf, torch.Tensor) else leaf)


def shard_module(module: nn.Module, mesh) -> nn.Module:
    """Place ``module``'s parameters on the mesh, in place: each becomes a
    DTensor on ``mesh['model']``. Every ``Dropout`` draws the global
    batch's mask and keeps this rank's rows; on a 'model' axis above one
    the attention and FFN blocks run their heads and columns of it and
    reduce over 'model'."""
    from m2tts_tpu_torch.models.components import (Dropout, FeedForward,
                                                   MultiHeadSelfAttention)

    mm = mesh["model"]
    n_model, i_model = mm.size(), mm.get_local_rank()
    i_data, n_data = batch_sharding(mesh)
    named = dict(module.named_parameters())
    specs = tree_shardings(named, mesh)
    for name, m in module.named_modules():
        if isinstance(m, Dropout):
            m.shard = [(0, i_data, n_data)]
    for name, m in module.named_modules():
        prefix = f"{name}." if name else ""
        # a block whose weights the rules split runs its part of them
        if (isinstance(m, MultiHeadSelfAttention)
                and specs[prefix + "qkv.weight"].is_shard()):
            if m.num_heads % n_model:
                raise ValueError(f"{m.num_heads} heads do not split over "
                                 f"model={n_model}")
            m.tp_group = mesh.get_group("model")
            m.dropout.shard.append((1, i_model, n_model))  # [B, heads, S, S]
        elif (isinstance(m, FeedForward)
              and specs[prefix + "fc1.weight"].is_shard()):
            m.tp_group = mesh.get_group("model")
            m.dropout.shard.append((2, i_model, n_model))  # [B, S, ffn]
    for name, p in named.items():
        owner, _, attr = name.rpartition(".")
        setattr(module.get_submodule(owner), attr, nn.Parameter(
            _place(name, p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad))
    return module


def local_module(module: nn.Module) -> nn.Module:
    """``module`` with every DTensor parameter replaced by its local
    tensor, in place: for serving, which runs no optimizer and hands the
    weights to kernels that read plain tensors."""
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        setattr(module.get_submodule(owner), attr, nn.Parameter(
            local(p.detach()), requires_grad=p.requires_grad))
    return module


def _is_sharded(t: torch.Tensor) -> bool:
    return isinstance(t, DTensor) and any(s.is_shard() for s in t.placements)


def sharding(tensors: Sequence[torch.Tensor]
             ) -> Tuple[List[bool], Optional[Any]]:
    """(whether each of ``tensors`` is sharded, the process group of the
    first sharded one's mesh, None when none is): what ``global_norm`` needs
    of their local tensors."""
    sharded = [_is_sharded(t) for t in tensors]
    group = next((t.device_mesh.get_group() for t, s in zip(tensors, sharded)
                  if s), None)
    return sharded, group


def place_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The local tensor ``t`` as a DTensor placed as the DTensor ``like`` is
    (its mesh, placements and global shape; no collective, shares ``t``'s
    storage); ``t`` as it is when ``like`` is a plain tensor."""
    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def global_norm(tensors: Sequence[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """optax's global norm of a gradient held as DTensors, or as their local
    tensors with ``sharded`` and ``group`` (``sharding`` of the DTensors):
    the local shards' sums of squares, all-reduced over ``group`` for the
    sharded ones only (a replicated tensor is whole on every rank). A plain
    tensor, the same on every rank."""
    tensors = list(tensors)
    if sharded is None:
        sharded, group = sharding(tensors)
        tensors = [local(t) for t in tensors]
    rep = [t for t, s in zip(tensors, sharded) if not s]
    shd = [t for t, s in zip(tensors, sharded) if s]
    rep_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(rep)))
    if not shd:
        return rep_norm
    sq = torch.stack(torch._foreach_norm(shd)).square().sum()
    dist.all_reduce(sq, group=group)
    return torch.sqrt(rep_norm.square() + sq)
