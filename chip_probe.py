#!/usr/bin/env python3
"""Time the spread kernel over block geometries on one NVIDIA GPU.

    python3 chip_probe.py [--seed S] [--np N ...] [--dtype D ...]

For each dtype (complex64, complex128, float32, float64) and point count,
at N = 256^3, m = 4, sigma = 1.5 (grid 384^3), uniform random points, the
script times the spread kernel (``ops/kernels/blocked.spread_blocked``, CUDA
events, median of 5 after one warm-up) at the geometry
``blocking.choose_geometry`` picks and at a few others, in the order
listed and then in reverse, and prints one JSON line per dtype and Np with
the mean of the two passes for each geometry.  It measures what the
chooser's cost model (halo ratio over resident CTAs) predicts.  Needs one
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GEOMETRIES = ((12, 12, 16), (12, 24, 24), (24, 24, 12), (8, 16, 16), (16, 16, 16),
              (8, 8, 12), (6, 8, 8), (8, 12, 12))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--np", type=int, nargs="+", default=[1_677_722, 16_777_216])
    parser.add_argument("--dtype", nargs="+",
                        default=["complex64", "complex128", "float32", "float64"])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a GPU")

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.ops.kernels.common import (
        MAX_SMEM_BYTES,
        VALUE_TYPES,
        spread_smem_bytes,
    )

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    for name in args.dtype:
        dtype = np.dtype(name)
        plan0 = nufft.PlanNUFFT(dtype, (256,) * 3, m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        _, sb, ncomp = VALUE_TYPES[plan0.dtype]
        dims = [plan0.block_dims] + [
            g for g in GEOMETRIES if g != plan0.block_dims
            and all(n % b == 0 for n, b in zip(plan0.shape_over, g))
            and spread_smem_bytes(g, 4, 8, sb, ncomp) <= MAX_SMEM_BYTES
        ]
        for np_ in args.np:
            gen = torch.Generator(device=dev).manual_seed(args.seed + np_)
            pts = torch.rand((3, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
            times = {g: [] for g in dims}
            for order in (dims, dims[::-1]):
                for g in order:
                    plan = nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
                    ms, _ = cuda_time_ms(lambda: blocked.spread_blocked(plan, vp))
                    times[g].append(ms)
                    del plan
                    torch.cuda.empty_cache()
            print(json.dumps({
                "dtype": name, "np": np_, "chosen": list(plan0.block_dims),
                "spread_ms": {"x".join(map(str, g)): sum(t) / len(t) for g, t in times.items()},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
