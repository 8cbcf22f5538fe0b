"""A look at the step after a training cell's window: which leaves read
far from the reference there, and why.

    python3 -m portbench.train_look --workload xl.gan-train \
        --seeds 1 2 3 [--seconds 51] [--at STEP ...] [--top 4]

Each seed runs the cell as a run does (set-up, the timed window, then one
more step, a replay of its bucket's graph, from the program's own state;
with ``--at``, one for each seed, the trainer first runs on to that step,
so that a run's state after its window is met again: the step after a
window is the set-up's steps plus the window's, which a run's standard
error gives) and then reads that step three more ways from the same
state:

- ``eager``: the program again, with graphs off (``disable_graphs``),
  from the trainer's own snapshot taken before the replay;
- ``f64``: the reference in float64;
- ``share``: for each spectral-normed discriminator weight, the norm of
  its float32 reference gradient over the norm of the gradient at its
  normalised weight divided by sigma: how much of the gradient the
  normalisation leaves (it takes out the part along the top singular
  pair; far under 1, the weight's gradient is a small remainder of
  larger terms that cancel);
- ``cancel``: for each discriminator weight, the norm of its float32
  reference gradient of the discriminator's loss over the sum of the
  norms of its two halves' gradients (the real rows' and the fake rows'):
  far under 1, the two nearly cancel and the gradient is a small
  remainder.

One JSON line a seed: for each reading of the step (``change.<net>``,
``grad.<net>``: ``train_compare``'s, against the float32 reference), its
median leaf and its ``--top`` worst leaves, each read by the replay, the
eager step and the float64 reference, with its ``share`` and ``cancel``;
and the median ``share`` and ``cancel`` over the discriminator's weights.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import train_compare as tc
from portbench.cellkit import free_device
from portbench.harness import find_cell, manifest, use_checkout_caches
from portbench.reference import gan
from portbench.reference import model as ref


class Look:
    """The driver's hooks around its step after the window: the trainer
    run on to step ``at`` (if given) and its snapshot before the step,
    then the same step eagerly from that snapshot."""

    def __init__(self, at: Optional[int] = None):
        self.at = at

    def before(self, trainer, it) -> None:
        while self.at is not None and trainer.step < self.at:
            if trainer._guarded_step(next(it)) is None:
                raise RuntimeError("out of memory on the way to the step")
        self.step = trainer.step
        self.snap = trainer._snapshot()

    def after(self, trainer, side, before: Dict, inp: Tuple,
              replay: Dict) -> None:
        from m2tts_tpu_torch.utils.graphs import disable_graphs

        from portbench.drivers.gan_train import _host

        self.before_state, self.inp, self.replay = before, inp, replay
        trainer._restore_snapshot(self.snap)
        with disable_graphs():
            metrics = trainer.train_step(inp[0])
        w, grads = side.weights(), side.grads(before)
        self.eager = {"losses": _host(metrics), "grad_tensors": grads,
                      "grad": {n: tc.leaf_norms(g) for n, g in grads.items()},
                      "change": {net: tc.diff_norms(w[net], before[net])
                                 for net in w if before.get(net) is not None}}
        del self.snap


def _cast(tree, dtype):
    """Every floating tensor of a (nested) dict, tuple or list in
    ``dtype``; the rest as it is."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _shares(ctx, before: Dict, inp: Tuple) -> Tuple[Dict, Dict[str, float]]:
    """(the float32 reference's record of the step, each spectral-normed
    discriminator weight's ``share``)."""
    from portbench.drivers.gan_train import _reference, follow_past

    seen: List[Tuple[torch.Tensor, torch.Tensor]] = []
    grads: Dict[int, torch.Tensor] = {}
    real = gan.spectral_normalize

    def recorded(w):
        out = real(w)
        if out.requires_grad:  # the discriminator step's own weights
            k = len(seen)
            seen.append((w.detach(), out.detach()))
            out.register_hook(lambda g, k=k: grads.__setitem__(k, g))
        return out
    gan.spectral_normalize = recorded
    try:
        one, _ = _reference(ctx)
        with ref.exact():
            rec = follow_past(one, before, inp)
    finally:
        gan.spectral_normalize = real
    names = [n for n, _, _ in gan.disc_param_spec() if n.endswith("weight")]
    shares = {}
    for k, (w, wn) in enumerate(seen[:len(names)]):
        sigma = torch.linalg.vector_norm(w) / torch.linalg.vector_norm(wn)
        leaf = w.clone().requires_grad_(True)
        with torch.enable_grad(), ref.exact():
            projected, = torch.autograd.grad(real(leaf), leaf, grads[k])
        shares[f"{names[k]}"] = float(torch.linalg.vector_norm(projected)
                                      / (torch.linalg.vector_norm(grads[k])
                                         / sigma))
    return rec, shares


def _cancel(ctx, before: Dict, inp: Tuple) -> Dict[str, float]:
    """Each discriminator weight's ``cancel`` in the float32 reference's
    discriminator step from ``before``."""
    from portbench.drivers.gan_train import recipe

    s, r, spectral = recipe(ctx)
    batch, drop_seed, off_seed = inp
    with torch.no_grad(), ref.exact():
        offsets, target = gan.window(batch, off_seed, r.seg_frames,
                                     r.upsample)
        _, _, fake = gan.generate(before["g"], s, batch, offsets,
                                  r.seg_frames, gan.Dropout(
                                      drop_seed, target.device, r.dropout))
    d = {k: v.detach().requires_grad_(True) for k, v in before["d"].items()}
    B = target.shape[0]
    with torch.enable_grad(), ref.exact():
        logits, _ = gan.discriminate(d, torch.cat([target, fake]),
                                     spectral=spectral)
        halves = [sum(((lg[:B] - 1.0) ** 2).mean() for lg in logits),
                  sum((lg[B:] ** 2).mean() for lg in logits)]
        real = torch.autograd.grad(halves[0], list(d.values()),
                                   retain_graph=True)
        fake_g = torch.autograd.grad(halves[1], list(d.values()))
    norm = torch.linalg.vector_norm
    return {k: float(norm(a + b) / (norm(a) + norm(b) + 1e-30))
            for k, a, b in zip(d, real, fake_g)}


def look(ctx, top: int) -> Dict:
    """The readings of one run's step after the window (``ctx.look``
    filled by the run)."""
    from portbench.drivers.gan_train import _reference, follow_past

    lk = ctx.look
    want, shares = _shares(ctx, lk.before_state, lk.inp)
    cancel = _cancel(ctx, lk.before_state, lk.inp)
    one, _ = _reference(ctx)
    f64 = follow_past(one, _cast(lk.before_state, torch.float64),
                      _cast(lk.inp, torch.float64))
    sides = {"replay": lk.replay, "eager": lk.eager, "f64": f64}
    leaves = {k: tc._leaf_readings(v, want) for k, v in sides.items()}
    out = {"numbers": {k: {n: round(x, 6) for n, x in tc.numbers(
        [v], [want]).items() if "past" in n} for k, v in sides.items()},
        "step": lk.step,
        "share_median": round(float(np.median(list(shares.values()))), 6),
        "cancel_median": round(float(np.median(list(cancel.values()))), 6)}
    for what, by_leaf in leaves["replay"].items():
        worst = sorted(by_leaf, key=by_leaf.get, reverse=True)[:top]
        out[what] = {"median": {k: round(float(np.median(list(
            leaves[k][what].values()))), 6) for k in sides}}
        for leaf in worst:
            row = {k: round(leaves[k][what].get(leaf, float("nan")), 6)
                   for k in sides}
            if what.endswith(".d") and leaf in shares:
                row["share"] = round(shares[leaf], 6)
            if what.endswith(".d") and leaf in cancel:
                row["cancel"] = round(cancel[leaf], 6)
            out[what][leaf] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--at", type=int, nargs="*", default=[])
    p.add_argument("--top", type=int, default=4)
    args = p.parse_args(argv)
    use_checkout_caches()
    from portbench.run import Context, run_cell

    man = manifest()
    cell = find_cell(man, args.workload)
    ats = list(args.at) + [None] * (len(args.seeds) - len(args.at))
    for seed, at in zip(args.seeds, ats):
        gc.unfreeze()  # the last run's trainer gone (see train_readings)
        free_device("cuda")
        ctx = Context(cell, seed, args.seconds, False)
        ctx.look = Look(at)
        out = run_cell(man, ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], **look(ctx, args.top)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
