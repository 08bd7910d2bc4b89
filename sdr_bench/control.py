"""The readings that the limits of ``correct`` are set from, at a cell's
own sizes and load: the program at the configuration's grade over many
seeds (the lower reading is their largest), and the control, the program
at the next grade below (``GRADE_BELOW``), over a few (the upper reading
is their smallest). One process, short windows; the benchmark's own runs
never run this.

    python3 sdr_bench/control.py --workload nfm320.capture --seeds 12 \\
        --control-seeds 3 --seconds 1 --first-seed 5000000001 \\
        --out readings.jsonl

Writes one JSON line a run (cell, grade, seed, numbers) to ``--out`` and
prints, per grade, each number's least and largest reading.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sdr_bench import harness, registry  # noqa: E402

# the nearest grade below each grade the port's kernels run
GRADE_BELOW = {"f32": "bf16x3", "bf16x3": "bf16x2"}
SEED_STEP = 1_000_003


def readings(name, grade, seeds, seconds, root=registry.ROOT,
             device="cuda"):
    """[(seed, {number: value})] of the cell at ``grade``."""
    out = []
    for seed in seeds:
        _, numbers = harness.run_cell(name, seed, seconds, False, root=root,
                                      device=device, grade=grade)
        out.append((seed, {k: v for k, (v, _) in numbers.items()}))
    return out


def summary(runs):
    """{number: (least, largest)} over runs."""
    keys = runs[0][1]
    return {k: (min(r[1][k] for r in runs), max(r[1][k] for r in runs))
            for k in keys}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=5_000_000_001)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    grade = registry.Cell(args.workload).config["precision"]
    below = GRADE_BELOW[grade]
    seeds = [args.first_seed + i * SEED_STEP for i in range(args.seeds)]
    plan = [(grade, seeds), (below, seeds[:args.control_seeds])]
    with open(args.out, "a", encoding="utf-8") as f:
        for g, ss in plan:
            runs = readings(args.workload, g, ss, args.seconds)
            for seed, nums in runs:
                f.write(json.dumps({"cell": args.workload, "grade": g,
                                    "seed": seed, "numbers": nums}) + "\n")
            for k, (lo, hi) in summary(runs).items():
                print(f"{args.workload} {g} {k}: least {lo!r} largest "
                      f"{hi!r} over {len(runs)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
