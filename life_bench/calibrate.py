"""Readings for the correctness limits: the numbers a cell compares, from
the program on many seeds and from its control in one process.

    python3 -m life_bench.calibrate --workload <name> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--out <file.jsonl>]

The control is the program with its own lower-precision path switched
on: ``compute_dtype="bf16"`` (bfloat16 storage of the dictionary and of
Phi's values, float32 sums), the step a later change would be tempted
by.  Each run prints one JSON line: the seed, the side, every number
compared and the limit file's verdict.  Runs on the CUDA card only.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from life_bench import run

CONTROL = {"compute_dtype": "bf16"}


def readings(files: dict, seeds, seconds: float, control: bool):
    """One dict of readings per seed."""
    out = []
    for seed in seeds:
        r = run.run_cell(files, seed, seconds, False, torch.device("cuda", 0),
                         overrides=CONTROL if control else None)
        rd = r.pop("_readings")
        out.append(dict(side="control" if control else "program", seed=seed,
                        correct=r["correct"], numbers=rd["found"],
                        judged_iters=rd["judged_iters"],
                        rate=r["metrics"]["subject_iters_per_s"]["value"]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    files = run.load_cell(args.workload)
    rows = (readings(files, args.seeds, args.seconds, False)
            + readings(files, args.control_seeds, args.seconds, True))
    lines = [json.dumps(dict(workload=args.workload, **r)) for r in rows]
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
