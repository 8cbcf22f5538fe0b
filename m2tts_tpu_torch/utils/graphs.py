"""One CUDA graph per bucket: the port's counterpart of ``jax.jit`` per shape.

The JAX package compiles each bucket into one XLA program and runs it with
one host dispatch (``Synthesizer._get_synth``, the streaming jits, the
jitted stage-1 step). Here a ``GraphRunner`` captures a function once per
key with ``torch.cuda.CUDAGraph`` and replays it after that:

- the key is the caller's key plus the shapes and dtypes of the tensor
  arguments, so a bucket is one graph;
- the first call of a key runs the function eagerly on the runner's side
  stream (that run is the call's result, and it builds the kernels, packs
  the vocoder's operands and primes cuBLAS), then captures it on the same
  stream into the owner's one memory pool (``graph_pool_handle``);
- later calls copy the arguments into the key's static input buffers (from
  any device, so a pinned host batch goes straight into them), replay, and
  return clones of the static outputs, so a result survives the next
  replay; copy-in, replay and copy-out hold the runner's lock, so threads
  on one device may share a runner;
- a graph reads nothing from a Python scalar: anything a replay depends on
  is a tensor argument (a scalar would be baked into the capture);
- a replay adds to the kernel wrappers' launch counters (``COUNTERS``) the
  launches its capture recorded; the capture itself counts none;
- Python's cyclic garbage collector is off while a capture is under way:
  a cycle it frees may hold another runner's graph, whose destruction
  inside the capture would invalidate it;
- a capture, its eager run included, is a ``graph.capture`` span (ident:
  the full key) while ``utils/profiling.py``'s tracing is on.

Graphs share the pool safely in any replay order because every graph's
outputs are read (cloned) right after its own replay, under the lock, and
its inputs live outside the pool.

On an NCCL mesh (``step_graphs``, the SPMD ``Synthesizer``) a graph holds
the collectives of the function it captures: a key's first call runs them
eagerly on the side stream (which creates the communicators) before the
capture; every rank captures a key at the same call and replays the same
keys in the same order, as the ranks of a mesh call everything alike; and
``capture_error_mode="thread_local"`` leaves the process group's watchdog
thread free to query its events while a capture is under way. Gloo's
collectives cannot be captured: a gloo mesh runs eagerly.

On the CPU, on a gloo mesh, inside ``disable_graphs()`` and while another
capture is under way the function runs eagerly. On CUDA a failed capture
raises; nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import threading
from typing import (Any, Callable, Dict, Hashable, Iterator, Optional,
                    Sequence, Tuple)

import torch

from m2tts_tpu_torch.utils.profiling import span

#: the kernel wrappers' launch counters as (module, attribute)
COUNTERS = (("m2tts_tpu_torch.ops.cuda.vocoder", "LAUNCHES_TC"),
            ("m2tts_tpu_torch.ops.cuda.vocoder", "LAUNCHES_TC32"),
            ("m2tts_tpu_torch.ops.cuda.build", "PROBE_LAUNCHES"))

_MU = threading.Lock()
_DISABLED = 0  # depth of open disable_graphs() contexts
_CAPTURES = 0  # captures under way, in every thread
_GC_WAS_ENABLED = True


@contextlib.contextmanager
def disable_graphs() -> Iterator[None]:
    """Run every ``GraphRunner`` call eagerly inside the block (in every
    thread), as ``jax.disable_jit()`` does for the JAX package; graphs
    already captured are kept for after it."""
    global _DISABLED
    with _MU:
        _DISABLED += 1
    try:
        yield
    finally:
        with _MU:
            _DISABLED -= 1


def graphs_enabled() -> bool:
    return _DISABLED == 0


@contextlib.contextmanager
def _gc_paused() -> Iterator[None]:
    """Python's cyclic collector off while any capture is under way: a
    cycle it frees may hold another runner's graph, and destroying a graph
    inside a capture invalidates the capture."""
    global _CAPTURES, _GC_WAS_ENABLED
    with _MU:
        if _CAPTURES == 0:
            _GC_WAS_ENABLED = gc.isenabled()
            gc.disable()
        _CAPTURES += 1
    try:
        yield
    finally:
        with _MU:
            _CAPTURES -= 1
            if _CAPTURES == 0 and _GC_WAS_ENABLED:
                gc.enable()


def _counts() -> Tuple[int, ...]:
    # a module that is not imported has launched nothing
    return tuple(getattr(sys.modules[m], a, 0) if m in sys.modules else 0
                 for m, a in COUNTERS)


def _add_counts(delta: Sequence[int]) -> None:
    for (m, a), d in zip(COUNTERS, delta):
        if d:
            mod = sys.modules[m]
            setattr(mod, a, getattr(mod, a) + d)


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor of a nest of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches", "replays")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.replays = launches, 0


class GraphRunner:
    """One CUDA graph per key for one owner (a Synthesizer, a streamer, a
    trainer) on ``device``; see the module docstring."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._lock = threading.RLock()
        self._pool = None
        self._stream = None
        self._failed: list = []  # graphs whose capture failed

    def active(self) -> bool:
        """Whether a call here captures or replays: on CUDA, outside
        ``disable_graphs()`` and outside another capture."""
        return (self.device.type == "cuda" and graphs_enabled()
                and not torch.cuda.is_current_stream_capturing())

    def __len__(self) -> int:
        return len(self._graphs)

    def stats(self) -> Dict[str, int]:
        """Graphs held and the replays made of them."""
        with self._lock:
            return {"graphs": len(self._graphs),
                    "replays": sum(g.replays for g in self._graphs.values())}

    def drop(self) -> None:
        """Forget every graph (their pool goes with the last of them); the
        next call of each key captures anew. Owners call it whenever a
        tensor a graph reads is replaced (weights, optimizer state)."""
        with self._lock:
            self._graphs.clear()
            self._pool = None

    def __call__(self, key: Hashable, fn: Callable[..., Any],
                 *args: torch.Tensor,
                 generators: Sequence[torch.Generator] = ()) -> Any:
        """``fn(*args)`` with ``args`` on this device: a replay of the graph
        of (``key``, the args' shapes and dtypes), captured at its first
        call. ``generators``: the CUDA generators ``fn`` draws from besides
        the default one; a replay draws from each as ``fn`` would from its
        state at the replay (so reseed it before the call)."""
        if not self.active():
            return fn(*(a.to(self.device, non_blocking=True) for a in args))
        full_key = (key, tuple((tuple(a.shape), a.dtype) for a in args))
        with self._lock:
            entry = self._graphs.get(full_key)
            if entry is None:
                with span("graph.capture", full_key):
                    return self._capture(full_key, fn, args, generators)
            for buf, a in zip(entry.inputs, args):
                buf.copy_(a, non_blocking=True)
            entry.graph.replay()
            entry.replays += 1
            _add_counts(entry.launches)
            return _tree_map(torch.Tensor.clone, entry.outputs)

    def _capture(self, full_key, fn, args, generators) -> Any:
        with torch.inference_mode(False):  # usable under every grad mode
            inputs = tuple(torch.empty(a.shape, dtype=a.dtype,
                                       device=self.device) for a in args)
        for buf, a in zip(inputs, args):
            buf.copy_(a, non_blocking=True)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        side = self._stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = fn(*inputs)  # this call's result, and the warm-up
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            before = _counts()
            with _gc_paused():
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = fn(*inputs)
                except BaseException:
                    # end the capture; an invalidated capture's capture_end
                    # raises and leaves its pool recording, so later graphs
                    # take a new pool (the failed graph is kept: the
                    # allocator's record of that pool refers to it)
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    self._failed.append(graph)
                    self._pool = None
                    raise
                finally:
                    launches = tuple(b - a
                                     for a, b in zip(before, _counts()))
                    _add_counts([-d for d in launches])  # a capture: none
                graph.capture_end()
        current.wait_stream(side)
        self._graphs[full_key] = _Graph(graph, inputs, outputs, launches)
        return result


def step_graphs(device, mesh) -> Optional[GraphRunner]:
    """The runner of an owner that may sit on a mesh (a trainer's step and
    eval graphs, the ``Synthesizer``'s buckets): one on CUDA, without a
    mesh or on a mesh whose process groups are NCCL's (the graphs then hold
    its collectives); None on the CPU and on a gloo mesh, which run
    eagerly."""
    from m2tts_tpu_torch.parallel.mesh import is_nccl

    device = torch.device(device)
    if device.type != "cuda" or (mesh is not None and not is_nccl(mesh)):
        return None
    return GraphRunner(device)
