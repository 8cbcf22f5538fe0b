"""Find a streaming cell's knee: the cell's mix at each of several fixed
rates, one run a rate in one process, each line the rate's first-chunk
tail and how it moved over the window.

    python3 -m portbench.sweep --workload flagship.stream --seed 7 \
        --seconds 10 --rates 200 400 800

The knee is the highest rate whose first-chunk p95 stays under the limit
and whose last quarter's p95 is not above twice its first quarter's (a
backlog that grows through the window); the cell's rate is 4/5 of it.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.harness import find_cell, manifest, use_checkout_caches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    use_checkout_caches()
    from portbench.run import Context, run_cell

    man = manifest()
    cell = find_cell(man, args.workload)
    for rate in args.rates:
        ctx = Context(cell, args.seed, args.seconds, False)
        ctx.mix = dict(ctx.mix, rate_per_s=rate)
        out = run_cell(man, ctx)
        q = ctx.last_record["first_chunk_p95_by_quarter_ms"]
        print(json.dumps({"rate_per_s": rate, "failed": out["failed"],
                          "attempted": out["attempted"],
                          "first_chunk_p95_ms":
                              ctx.last_record["first_chunk_p95_ms"],
                          "by_quarter_ms": q,
                          "correct": out["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
