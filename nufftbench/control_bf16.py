"""Readings behind the limits of a single-precision cell: the program's runs
on a dozen seeds and the control's on a few more, in one process, at the
cell's own size.

    python3 nufftbench/control_bf16.py --workload <name> --seed <first> \\
        [--program 12] [--control 3] [--seconds 2]

The control is the program at the configuration's own value type, with the
values and the spectrum each step takes rounded through bfloat16 (8
significant bits, the nearest precision below float32) before the call, on
the same draws; the reference still computes from the draws themselves.
``control.py`` casts to the value type below the configuration's instead,
which a complex64 configuration has none of.  Each run prints one JSON line
(``kind``, ``seed``, the numbers compared); the last line gives, for each
number, the lower reading (the largest of the program's) and the upper one
(the smallest of the control's).  The benchmark's own runs never run this.
Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from nufftbench import harness  # noqa: E402


def through_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through bfloat16, a complex tensor part by part, in its
    own dtype."""
    if x.is_complex():
        return torch.complex(through_bf16(x.real), through_bf16(x.imag))
    return x.to(torch.bfloat16).to(x.dtype)


class RoundedSteps(harness.Steps):
    """The harness's steps on values and a spectrum rounded through
    bfloat16."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.values = through_bf16(self.values)
        self.spectrum = through_bf16(self.spectrum)


def run_rounded(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """``harness.run_cell`` with the program's inputs rounded through
    bfloat16: the control."""
    with mock.patch.object(harness, "Steps", RoundedSteps):
        return harness.run_cell(cell, seed, seconds, trace, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--program", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    runs = [("program", False)] * args.program + [("control", True)] * args.control
    readings = {"program": {}, "control": {}}
    for i, (kind, rounded) in enumerate(runs):
        seed = args.seed + i
        run = run_rounded if rounded else harness.run_cell
        res = run(cell, seed, args.seconds, False, "cuda")
        vals = {n: c["value"] for n, c in res["checks"].items()}
        for n, v in vals.items():
            readings[kind].setdefault(n, []).append(v)
        print(json.dumps({"kind": kind, "inputs": "bfloat16" if rounded else cell.config["dtype"],
                          "seed": seed, "failed": res["failed"], "steps": res["run"]["steps"],
                          "check_s": res["run"]["check_s"], **vals}), flush=True)
        torch.cuda.empty_cache()
    summary = {n: {"lower": max(readings["program"][n]),
                   "upper": min(readings["control"][n]) if readings["control"] else None}
               for n in readings["program"]}
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
