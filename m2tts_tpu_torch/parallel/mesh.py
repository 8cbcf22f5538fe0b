"""The ('data', 'model') device mesh of the port and its collectives.

Counterpart of ``m2tts_tpu/parallel/mesh.py``. The JAX package is one
process over a ``Mesh`` of chips, and XLA inserts the collectives when a
jitted step consumes sharded inputs. PyTorch runs one process per device
(``torchrun --nproc-per-node N``), so here the mesh is a 2-D
``torch.distributed`` ``DeviceMesh`` of ranks, and the few collectives the
port needs are written out:

- batches shard over 'data': every rank builds the same global batch and
  keeps its contiguous rows (``shard_batch``); the gradient of the global
  mean is the mean over 'data' of the ranks' gradients (``mean_over``);
- ``replicate_tree`` broadcasts from the mesh's first rank, so every rank
  starts from the same weights whatever its seed (JAX's ``replicated(mesh)``
  sharding is a DTensor's ``Replicate()`` placement here,
  ``parallel/partition.py``);
- the tensor-parallel blocks (``parallel/partition.py``) enter and leave
  the 'model' axis through ``copy_to_model`` and ``reduce_from_model``:
  Megatron's f (identity forward, all-reduce backward) and g (all-reduce
  forward, identity backward);
- ``all_gather_rows`` brings each rank's rows of a result back whole.

Gloo takes CUDA tensors for every collective used here, so ranks may share
one card over gloo; NCCL needs one card a rank. ``mesh=None`` everywhere
else in the port is the single-device path, which touches none of this.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from m2tts_tpu_torch.utils.device import resolve_device

AXES = ("data", "model")


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the default process group (a no-op when one is up) and return
    this rank's device: ``cuda:{LOCAL_RANK}`` (made current) for a CUDA
    ``device``, the CPU otherwise. ``backend`` defaults to NCCL for CUDA and
    gloo for the CPU; a CUDA device without CUDA raises. ``init_method``,
    ``rank`` and ``world_size`` default to torchrun's environment
    (``env://``, ``RANK``, ``WORLD_SIZE``); a ``file://`` path or
    ``tcp://host:port`` may be given instead."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", -1))
        if local < 0:  # spawned without torchrun: ranks fill the cards
            r = rank if rank is not None else int(os.environ.get("RANK", 0))
            local = r % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://",
            rank=int(os.environ["RANK"]) if rank is None else rank,
            world_size=(int(os.environ["WORLD_SIZE"]) if world_size is None
                        else world_size))
    return dev


def make_mesh(data: int = -1, model: int = 1,
              device_type: Optional[str] = None):
    """A ('data', 'model') ``DeviceMesh`` over every rank of the process
    group; ``data=-1`` takes world size // model. Raises without a process
    group, and when the world is not data × model ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs one process per device: launch "
            "with torchrun --nproc-per-node N, or call init_distributed "
            "first")
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, "
                         f"have {n}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def mesh_from_config(config, device: torch.device):
    """The mesh ``system.mesh`` asks for when a process group is up; None
    (the single-device path) without one, where a mesh above one device
    raises with the command that launches it."""
    data = int(config.get("system.mesh.data", -1))
    model = int(config.get("system.mesh.model", 1))
    if dist.is_initialized():
        return make_mesh(data, model, device_type=device.type)
    if data not in (-1, 1) or model != 1:
        n = max(data, 1) * model
        raise RuntimeError(
            f"system.mesh data={data} model={model} runs one process per "
            f"device: launch it with torchrun --nproc-per-node {n} (or call "
            "parallel.mesh.init_distributed before building the trainer)")
    return None


def batch_sharding(mesh) -> Tuple[int, int]:
    """(this rank's index on 'data', the size of 'data'): the rank keeps
    rows ``[index·B/size, (index+1)·B/size)`` of a global batch of B."""
    return mesh["data"].get_local_rank(), mesh["data"].size()


def rows(x, index: int, count: int):
    """Rows ``[index·B/count, (index+1)·B/count)`` of ``x`` (numpy or
    torch); raises when B does not divide."""
    B = x.shape[0]
    if B % count:
        raise ValueError(f"batch of {B} rows not divisible by the mesh "
                         f"'data' axis ({count})")
    b = B // count
    return x[index * b:(index + 1) * b]


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of every array of a global batch; 0-d entries
    (``n_valid``) stay whole."""
    index, count = batch_sharding(mesh)
    return {k: rows(v, index, count) if getattr(v, "ndim", 0) > 0 else v
            for k, v in batch.items()}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate_tree(tree: Any, mesh) -> Any:
    """Broadcast every tensor of a nest of dicts and lists from the mesh's
    first rank to all its ranks, in place (one flat buffer per dtype and
    device); returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in _tensors(tree):
        groups.setdefault((t.dtype, t.device), []).append(local(t))
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src)
            torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
                flat.split([t.numel() for t in ts]), ts)])
    return tree


def local(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of a DTensor (differentiable; in-place writes reach
    the DTensor), anything else as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_leaf(t: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter's local tensor as a leaf of its own that shares
    its storage: in-place writes reach the DTensor, autograd differentiates
    by it, and nothing done on it dispatches through DTensor. Anything else
    as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.detach().to_local().detach().requires_grad_(t.requires_grad)


def is_nccl(mesh) -> bool:
    """Whether every process group of ``mesh`` is NCCL's: a CUDA graph
    captures NCCL's collectives, and none of gloo's."""
    return all(dist.get_backend(mesh.get_group(axis)) == "nccl"
               for axis in mesh.mesh_dim_names)


@torch.no_grad()
def mean_over(tensors: Sequence[torch.Tensor], mesh, axis: str = "data"
              ) -> None:
    """Replace each tensor (or DTensor's local shard) by its mean over the
    mesh ``axis``, in place: one all-reduce of a flat buffer per dtype."""
    n = mesh[axis].size()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        lt = local(t)
        by_dtype.setdefault(lt.dtype, []).append(lt)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=mesh.get_group(axis))
        flat.div_(n)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


def mean_dict_over(values: Dict[str, torch.Tensor], mesh,
                   axis: str = "data") -> Dict[str, torch.Tensor]:
    """A dict of 0-d tensors, each replaced by its mean over ``axis``."""
    stacked = torch.stack([v.detach() for v in values.values()])
    mean_over([stacked], mesh, axis)
    return dict(zip(values, stacked.unbind()))


def all_gather_rows(t: torch.Tensor, mesh, axis: str = "data"
                    ) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated on dim 0 in rank
    order. 2-byte integers travel as bytes (NCCL has no int16)."""
    n = mesh[axis].size()
    if n == 1:
        return t
    x = t.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.int16 else x
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=mesh.get_group(axis))
    return out.view(torch.int16) if x.dtype == torch.int16 else out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (pickled; only for objects this
    program made)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward; the backward sums the partial input
    gradients of the 'model' ranks."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.pg)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the forward sums the ranks' partial outputs; identity
    backward (every 'model' rank holds the whole output gradient)."""

    @staticmethod
    def forward(ctx, x, pg):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=pg)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, pg) -> torch.Tensor:
    return _CopyToModel.apply(x, pg)


def reduce_from_model(x: torch.Tensor, pg) -> torch.Tensor:
    return _ReduceFromModel.apply(x, pg)


# -- worlds of processes ---------------------------------------------------

def _world_entry(rank: int, fn: Callable, nprocs: int, workdir: str,
                 backend: Optional[str], device: str, args: tuple) -> None:
    torch.set_num_threads(1)
    init_distributed(device, backend, f"file://{workdir}/pg", rank, nprocs)
    try:
        torch.save(fn(*args), os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, nprocs: int, args: tuple = (),
                backend: Optional[str] = None, device: str = "cpu",
                timeout: float = 600.0,
                workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` new processes (``spawn``), each rank
    of one process group (``file://`` rendezvous in ``workdir``, a temporary
    directory by default), and return their results in rank order. ``fn``
    must be importable by name. A rank's exception is raised here; a world
    that outlives ``timeout`` seconds is killed and raises."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ctx = mp.start_processes(
            _world_entry, args=(fn, nprocs, tmp, backend, device, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {nprocs} ranks ran past "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
