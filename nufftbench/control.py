"""Readings behind a cell's limits: the program's runs on a dozen seeds and
the control's on a few more, in one process, at the cell's own size.

    python3 nufftbench/control.py --workload <name> --seed <first> \\
        [--program 12] [--control 3] [--seconds 2]

The control is the program with its lower-precision path switched on: the
same cell run with complex64 values in place of complex128, float32 in
place of float64 (``harness.LOWER``), on the same inputs.  Each run prints
one JSON line (``kind``, ``seed``, the numbers compared); the last line
gives, for each number, the lower reading (the largest of the program's)
and the upper one (the smallest of the control's).  The benchmark's own
runs never run this.  Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--program", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from nufftbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    lower = harness.LOWER[cell.config["dtype"]]
    runs = [("program", None)] * args.program + [("control", lower)] * args.control
    readings = {"program": {}, "control": {}}
    for i, (kind, dtype) in enumerate(runs):
        seed = args.seed + i
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", dtype=dtype)
        vals = {n: c["value"] for n, c in res["checks"].items()}
        for n, v in vals.items():
            readings[kind].setdefault(n, []).append(v)
        print(json.dumps({"kind": kind, "dtype": dtype or cell.config["dtype"], "seed": seed,
                          "failed": res["failed"], "steps": res["run"]["steps"],
                          "check_s": res["run"]["check_s"], **vals}), flush=True)
        torch.cuda.empty_cache()
    summary = {n: {"lower": max(readings["program"][n]),
                   "upper": min(readings["control"][n]) if readings["control"] else None}
               for n in readings["program"]}
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
