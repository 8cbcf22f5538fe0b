"""The control's readings: the reference put in the program's place and
computed one precision below the configuration's, held to the float32
reference by the same comparison a run makes, on the same sample of the
same traffic.

    python3 -m portbench.readings --workload <cell> --seeds 1 2 3 \
        [--control fp8]

Prints one JSON line per seed with the compared numbers and ``correct``,
the verdict of the cell's own check (``compare.checks`` on
``limits/<cell>.json``), which the control has to fail. The synthesis
the configuration states in bfloat16 runs in ``fp8`` (per-tensor scaled
e4m3); the streaming short path, float32 in the program, runs in TF32.
The duration probe that picks a batch's frame bucket stays float32, as
the configuration states. A run's own lines give the program's readings;
the limits lie between the two.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

from portbench import compare
from portbench.cellkit import Cell, bucket_for, pick_sample
from portbench.harness import find_cell, load_json, manifest

HALO = 4  # the streaming vocoder's halo frames on each side of a chunk


def control_numbers(cell_name: str, seed: int, control: str,
                    device: str = "cuda", man: Dict = None,
                    config: Dict = None, mix: Dict = None) -> Dict:
    man = man or manifest()
    cell_def = find_cell(man, cell_name)
    config = config or load_json("configs", cell_def["config"])
    mix = mix or load_json("traffic", cell_def["traffic"])
    pairs = []
    if mix["driver"] == "bulk":
        B, pool = int(mix["batch"]), int(mix["pool"])
        cell = Cell(config, mix, seed, device, pool)
        sample = pick_sample(cell, pool)
        for idx in sorted(sample):
            call, row = cell.texts[idx - idx % B: idx - idx % B + B], idx % B
            fb = cell.serving["frame_buckets"]
            own = bucket_for(int(cell.totals[idx - row: idx - row + B].max()),
                             fb)
            want = cell.batch_audio(call, [row], own)[0]
            got = cell.batch_audio(call, [row], own, control=control)[0]
            pairs.append((got, want))
    else:
        n = max(1, int(round(float(mix["rate_per_s"]) * man["run_seconds"])))
        cell = Cell(config, mix, seed, device, n)
        sample = pick_sample(cell, n)
        W = int(config["serving"]["stream"]["chunk_frames"]) + 2 * HALO
        for i in sorted(sample):
            pairs.append((cell.stream_audio(cell.texts[i], W, control),
                          cell.stream_audio(cell.texts[i], W)))
    return compare.numbers(pairs, cell.hop)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default="fp8")
    args = p.parse_args(argv)
    limits = load_json("limits", args.workload)
    for seed in args.seeds:
        nums = control_numbers(args.workload, seed, args.control)
        correct, checks = compare.checks(nums, limits)
        nums["each"] = str(nums["each"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "correct": correct,
                          **nums, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
