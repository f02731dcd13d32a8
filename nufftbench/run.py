"""Run one cell of the benchmark once and print its result.

    python3 nufftbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``nufftbench/``
and the program, ``nonuniformffts_tpu_torch``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; last in it,
``checks``, each number compared with its limit.  The last lines of
standard error are the same numbers.  Without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it exits with another code than 0 and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that may not be loaded in the process that
#: prints the result: JAX, its libraries and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "nonuniformffts_tpu")
#: Build and kernel caches, at fixed paths inside the checkout (the
#: program's own nvcc build goes to build/nonuniformffts_tpu_torch/).
CACHES = {"CUDA_CACHE_PATH": "build/nufftbench/cuda_cache",
          "TORCH_EXTENSIONS_DIR": "build/nufftbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/nufftbench/triton"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT))
    marks = {}
    import torch

    from nufftbench import harness

    marks["import_torch"] = time.perf_counter() - T_START

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count = {torch.cuda.device_count()}")
        return 2
    torch.cuda.init()
    marks["cuda_init"] = time.perf_counter() - T_START
    import nonuniformffts_tpu_torch  # noqa: F401  (the program; fails without it)

    marks["import_program"] = time.perf_counter() - T_START
    torch.set_num_threads(4)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_start=T_START)
    result["run"]["setup"] = {**marks, **result["run"]["setup"]}
    log(f"card after the run (name, power limit, SM clock, its maximum, temperature): "
        f"{card_line()}")
    error = result.pop("error")
    if error:
        log(f"first failed step:\n{error}")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        **result["device"]}
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
