"""Readings of a training cell's check for its limits: the program's
numbers, the control's (the reference one precision below in the
program's place, against the float32 reference on the same steps) and
each planted fault's, from runs in one process.

    python3 -m portbench.train_readings --workload xl.gan-train \
        --seeds 1 2 3 [--control fp8] [--faults half_batch altered] \
        [--seconds 10]

Each seed runs the cell once with the control read beside the program
(``Context.control``), then once per fault (``train_faults.FAULTS``)
planted in the program. One JSON line a run: the numbers, and
``correct``, the cell's own verdict on them (``compare.checks`` on
``limits/<cell>.json``). The limits lie above the program's readings over
a dozen seeds and below the control's and the faults'.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, Optional

from portbench import compare
from portbench.cellkit import free_device
from portbench.harness import find_cell, manifest, use_checkout_caches
from portbench.train_faults import FAULTS


def _line(workload: str, seed: int, what: str, nums: Dict,
          limits: Dict) -> str:
    correct, checks = compare.checks(nums, limits)
    return json.dumps({"workload": workload, "seed": seed, "run": what,
                       "correct": correct, **nums, "checks": checks})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default="fp8")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    use_checkout_caches()
    from portbench.run import Context, run_cell

    man = manifest()
    cell = find_cell(man, args.workload)
    for seed in args.seeds:
        for fault in [None] + list(args.faults):
            # a run freezes what its set-up made (``gc.freeze``); the next
            # run in this process needs the last one's trainer gone
            gc.unfreeze()
            free_device("cuda")
            ctx = Context(cell, seed, args.seconds, False,
                          inject=FAULTS[fault] if fault else None)
            ctx.control = None if fault else args.control
            out = run_cell(man, ctx)
            prog = getattr(ctx, "numbers", None) or {
                k: out["checks"][k]["value"] for k in out["checks"]}
            print(_line(args.workload, seed, fault or "program", prog,
                        ctx.limits), flush=True)
            other: Optional[Dict] = getattr(ctx, "control_numbers", None)
            if other is not None:
                print(_line(args.workload, seed, f"control {args.control}",
                            other, ctx.limits), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
