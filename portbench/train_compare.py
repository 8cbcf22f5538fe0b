"""How a training step is held to the reference's.

Each side (the program, the reference, a control) gives a record of each
compared step: its ``losses`` by name as the step reports them, and where
read, ``grad_tensors`` (each leaf's gradient as the optimizer got it,
after the clip, by net) with their norms ``grad``, and ``change`` (the
norm of each leaf's change, by net; the generator's EMA is the net
``ema``). A record marked ``past`` is the step after the timed window, a
replay of its graph from the program's own state; the others are the
first steps from the seed's weights.

Readings, by phase (``first``, ``past``) and quantity, each leaf's:

- ``loss``: ``|loss − loss_ref| / |loss_ref|`` of each term (a term the
  program does not report reads 0);
- ``grad.<net>``: ``‖g − g_ref‖`` over the larger of ``‖g_ref‖`` and the
  net's median leaf's (a leaf the program lacks reads ``‖g_ref‖``);
- ``gap.<net>``: the same leaf's gap of norms, ``|‖g‖ − ‖g_ref‖|`` over
  the same (shown only: rounding that does not lean with the gradient
  moves a norm only to second order);
- ``change.<net>``: the gap between the norms of each leaf's change and
  the reference's, over the same, leaving out the leaves whose reference
  gradient is under ``NOUGHT`` of its net's median leaf's (nought to
  rounding: those move under Adam by round-off alone). Norms, not
  differences: Adam's early steps move every element by about the lr
  whatever its gradient's sign, which is rounding where the gradient is
  all but zero.

Each reading gives its ``median`` leaf and its ``worst`` leaf, the
largest over the phase's steps. ``NUMBERS`` says which of them each
number takes (PERF.md §2 gives the readings behind each choice): a median
where the worst leaf swings from seed to seed in sound runs without
separating the control, the worst leaf elsewhere. A cell's limits file
names the numbers it compares; the others are shown.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

NOUGHT = 1e-3
TINY = 1e-12
WORST = 1e3  # what a non-finite comparison reads
#: compared number -> (the readings it takes the largest of, the statistic)
NUMBERS = {
    "loss_rel_err": (("first.loss",), "worst"),
    "grad_rel_err.g": (("first.grad.g",), "worst"),
    "grad_rel_err.d": (("first.grad.d",), "median"),
    "update_rel_err": (("first.change.g", "first.change.d"), "worst"),
    "loss_past_rel_err": (("past.loss",), "median"),
    "grad_past_rel_err.g": (("past.grad.g",), "median"),
    "grad_past_rel_err.d": (("past.grad.d",), "median"),
    "update_past_rel_err": (("past.change.g", "past.change.d",
                             "past.change.ema"), "median"),
}
NAMES = tuple(NUMBERS)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The float32 norm of each tensor, read in one transfer."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def diff_norms(after: Dict[str, torch.Tensor],
               before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return leaf_norms({k: after[k].float() - before[k].float()
                       for k in before})


def _finite(x: float) -> float:
    return x if math.isfinite(x) else WORST


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms over max(its reference norm, the median
    leaf's)."""
    if not ref:
        return {}
    med = float(np.median(list(ref.values())))
    return {k: _finite(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med,
                                                             TINY))
            for k in (ref if keep is None else keep)}


def _diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
           norms: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's ‖prog − ref‖ over max(‖ref‖, the median leaf's)."""
    med = float(np.median(list(norms.values())))
    d = leaf_norms({k: (prog[k].float() - ref[k].float() if k in prog
                        else ref[k].float()) for k in ref})
    return {k: _finite(v / max(norms[k], med, TINY)) for k, v in d.items()}


def _leaf_readings(p: Dict, r: Dict) -> Dict[str, Dict[str, float]]:
    """One step's readings by quantity, each leaf's (or loss term's)."""
    out = {}
    if "losses" in r:
        out["loss"] = {k: _finite(abs(p.get("losses", {}).get(k, 0.0) - v)
                                  / max(abs(v), TINY))
                       for k, v in r["losses"].items()}
    for net, norms in r.get("grad", {}).items():
        out[f"grad.{net}"] = _diffs(p.get("grad_tensors", {}).get(net, {}),
                                    r["grad_tensors"][net], norms)
        out[f"gap.{net}"] = _gaps(p.get("grad", {}).get(net, {}), norms)
    for net, norms in r.get("change", {}).items():
        g = r["grad_for_change"]["g" if net == "ema" else net]
        med = float(np.median(list(g.values())))
        keep = [k for k in norms if g.get(k, 0.0) >= NOUGHT * med]
        out[f"change.{net}"] = _gaps(p.get("change", {}).get(net, {}),
                                     norms, keep)
    return {k: v for k, v in out.items() if v}


def numbers(prog: List[Dict], ref: List[Dict]) -> Dict:
    """The compared numbers of ``prog``'s records against ``ref``'s (step
    by step), each under its name in ``NUMBERS``; ``compared``, the steps
    compared; ``worst``, where each number was set; ``readings``, every
    reading's median and worst leaf, ``[median, worst, where]``."""
    table: Dict[str, Dict[str, Tuple[float, str]]] = {}
    for i, (p, r) in enumerate(zip(prog, ref)):
        phase = "past" if r.get("past") else "first"
        for what, leaves in _leaf_readings(p, r).items():
            row = table.setdefault(f"{phase}.{what}", {})
            worst = max(leaves, key=leaves.get)
            for stat, v, where in (
                    ("median", float(np.median(list(leaves.values()))),
                     f"step {i}"),
                    ("worst", leaves[worst], f"step {i}: {worst}")):
                if v >= row.get(stat, (-1.0, ""))[0]:
                    row[stat] = (v, where)
    out, worst = {}, {}
    for name, (keys, stat) in NUMBERS.items():
        got = [(table[k][stat][0], f"{k} {stat}, {table[k][stat][1]}")
               for k in keys if k in table]
        out[name], worst[name] = max(got) if got else (0.0, "")
    out.update(compared=min(len(prog), len(ref)), worst=worst,
               readings={k: [round(v["median"][0], 6),
                             round(v["worst"][0], 6), v["worst"][1]]
                         for k, v in table.items()})
    return out
