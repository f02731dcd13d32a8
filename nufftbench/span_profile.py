"""The program's spans over a profiled stretch of a cell, label by label.

    python3 nufftbench/span_profile.py --workload <name> --seed <first> \\
        [--runs 1] [--seconds 2] [--keep-trace DIR]

Each run builds the cell's plain plan (no timer) as a traced benchmark run
does, runs three warm-up steps and ``harness.PROFILE_WARMUP`` more under
``torch.profiler``, then steps for ``--seconds`` inside the harness's window
annotation, and prints one JSON line: the steps and steps a second of the
profiled window, ``device_idle_pct`` and the idle gaps (``trace.py``), the
per-label table of the program's spans a step (``spans.py``: ``count``,
``device_ms``, ``self_device_ms``, ``blocking``, ``idle_ms``,
``self_idle_ms``), the kernel library's load record
(``ops/kernels/build.py:LOAD``) and the readings that table gives
(:func:`readings`).  Run ``r`` takes the seed ``first + r``.  With
``--keep-trace`` each run's Chrome trace is kept there.  The benchmark's
own runs never run this.  Needs a CUDA card.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(table: dict, load: dict | None) -> dict:
    """The span readings of a run from its per-step table (span name ->
    fields a step) and the load record; a reading whose spans are absent
    is left out.

    - ``sort_ms``: device ms launched inside ``set_points/(2) bin sort``;
    - ``set_points_syncs``: host-blocking calls inside ``set_points``;
    - ``exec_syncs``: host-blocking calls inside ``exec_type1`` and
      ``exec_type2``;
    - ``exec_idle_ms``: device-idle ms while the host is inside them;
    - ``library_load_s``: hash, compile and ``dlopen`` seconds of the
      kernel library's load."""
    from nufftbench.spans import SPAN_PREFIX

    def get(label, field):
        row = table.get(SPAN_PREFIX + label)
        return None if row is None else row[field]

    out = {"sort_ms": get("set_points/(2) bin sort", "device_ms"),
           "set_points_syncs": get("set_points", "blocking")}
    execs = [label for label in ("exec_type1", "exec_type2") if SPAN_PREFIX + label in table]
    if execs:
        out["exec_syncs"] = sum(get(label, "blocking") for label in execs)
        out["exec_idle_ms"] = sum(get(label, "idle_ms") for label in execs)
    if load and load["hash_s"]:
        out["library_load_s"] = load["hash_s"] + load["compile_s"] + load["dlopen_s"]
    return {k: v for k, v in out.items() if v is not None}


def per_step(table: dict, steps: int) -> dict:
    """``spans.reduce``'s table a step, seconds as ms."""
    out = {}
    for name, row in table.items():
        out[name] = {"count": row["count"] / steps, "blocking": row["blocking"] / steps,
                     **{k[:-2] + "_ms": 1e3 * row[k] / steps
                        for k in ("device_s", "self_device_s", "idle_s", "self_idle_s")}}
    return out


def profile_cell(cell, seed: int, seconds: float, device, keep_trace=None) -> dict:
    """One profiled stretch of ``cell`` on ``device``; the run's line."""
    import torch

    from nufftbench import harness, spans, trace
    from nufftbench.traffic import Traffic
    from nonuniformffts_tpu_torch.ops.kernels import build

    device = torch.device(device)
    traffic = Traffic(cell.config, cell.traffic, seed, device)
    step = harness.Steps(cell, traffic, device, cell.config["dtype"], marks=True)
    win = harness.Window(0)
    k = 0
    for _ in range(harness.WARMUP_STEPS):
        step(k)
        k += 1
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(harness.PROFILE_WARMUP):
            win.one(step, k)
            k += 1
        k0 = k
        t0 = time.perf_counter()
        with torch.profiler.record_function(trace.WINDOW):
            k = win.run(step, k, seconds, timed=False)
        window_s = time.perf_counter() - t0
    steps = k - k0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if keep_trace is not None:
            os.makedirs(keep_trace, exist_ok=True)
            shutil.copy(path, os.path.join(keep_trace, f"{cell.name}.{seed}.json"))
    summary = trace.summarise(events)
    table = per_step(spans.reduce(events), steps)
    load = dict(build.LOAD)
    line = {"workload": cell.name, "seed": seed, "failed": win.failed, "steps": steps,
            "window_s": window_s, "steps_per_s": steps / window_s,
            "device_idle_pct": None if summary is None
            else 100.0 * (1.0 - summary["busy_s"] / summary["window_s"]),
            "idle_gaps": None if summary is None else summary["idle_gaps"],
            "readings": readings(table, load), "library_load": load, "spans": table}
    if win.error:
        line["error"] = win.error
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--keep-trace", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from nufftbench import harness
    from nufftbench.run import card_line

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    for r in range(args.runs):
        line = profile_cell(cell, args.seed + r, args.seconds, "cuda", args.keep_trace)
        line["card"] = card_line()
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
