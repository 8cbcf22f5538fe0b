"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``); the mix names its driver
(``drivers/<driver>.py``), and each per-layer metric is read by
``layer_metrics/<metric>.py``; the limits of the cell's check are in
``limits/<cell>.json``. A run makes its weights and inputs from the seed,
warms up the shapes its traffic uses, measures for ``--seconds``, then
holds a sample of what it served to the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each compared number beside its
limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import math
import sys
import time
from typing import Dict, Optional

from portbench import compare
from portbench.harness import (HERE, applies, device_info, emit, find_cell,
                               forbidden_modules, load_json, manifest,
                               process_start, say, use_checkout_caches)


class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    hooks the harness keeps (set-up's end, the memory peak)."""

    def __init__(self, cell: Dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", started: Optional[float] = None,
                 inject=None, config: Optional[Dict] = None,
                 mix: Optional[Dict] = None, limits: Optional[Dict] = None):
        self.cell = cell
        self.config = config or load_json("configs", cell["config"])
        self.mix = mix or load_json("traffic", cell["traffic"])
        self.limits = limits or load_json("limits", cell["name"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        self.started = process_start() if started is None else started
        self.setup_s: Optional[float] = None
        self._inject = inject
        self.marks: Dict[str, float] = {}
        self._last = self.started

    def mark(self, what: str) -> None:
        """Close the set-up stretch ``what`` (seconds since the last mark,
        the first from the process's start)."""
        now = time.time()
        self.marks[what] = self.marks.get(what, 0.0) + now - self._last
        self._last = now

    def inject(self, program) -> None:
        """A test's hook into the program a driver built (no-op in a run)."""
        if self._inject is not None:
            self._inject(program)

    def setup_done(self) -> None:
        """Set-up's end: what set-up made is frozen out of the collector's
        passes (``gc.freeze``), as a server does once it has loaded."""
        gc.collect()
        gc.freeze()
        self.mark("other")
        self.setup_s = time.time() - self.started
        say("set-up split (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.marks.items())
            + f"; total {self.setup_s:.3f}")

    def memory_peak(self) -> int:
        import torch

        if torch.device(self.device).type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def layer_reader(name: str):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.layer_metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(man: Dict, ctx: Context) -> Dict:
    """Drive the cell once; the result object (without printing it)."""
    driver = importlib.import_module(f"portbench.drivers.{ctx.mix['driver']}")
    out = driver.run(ctx)
    ctx.last_record = out["record"]
    correct, checks = compare.checks(out["numbers"], ctx.limits)
    correct = correct and out["failed"] == 0
    name = ctx.cell["name"]
    metrics = {}
    if not ctx.trace:
        values = dict(out["metrics"], setup_s=ctx.setup_s)
        for m in man["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        rec = out["record"]
        for m in man["per_layer"]:
            if applies(m, name):
                v = layer_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = [k for k, v in metrics.items() if not math.isfinite(v["value"])]
    if bad:
        raise RuntimeError(f"metrics without a finite value: {bad}")
    device = device_info(ctx.device, out["memory_peak_bytes"])
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        win = out["window"]
        device["busy_s"] = out["record"]["busy_s"]
        device["window_s"] = out["record"]["window_s"]
        result["breakdown"] = {"device_ops": win.top_ops(),
                               "idle_gaps": win.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout_caches()
    man = manifest()
    cell = find_cell(man, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        say(f"no result: the cell needs {cell['chips']} CUDA device(s), "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  started=started)
    ctx.mark("import")
    torch.empty(1, device="cuda")
    ctx.mark("cuda_context")
    result = run_cell(man, ctx)
    found = forbidden_modules()
    if found:
        say(f"no result: the run loaded {found}")
        return 4
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
