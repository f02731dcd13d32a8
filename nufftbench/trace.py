"""The reduction of a ``torch.profiler`` trace (Chrome trace format) to the
device's busy time, the traced window and the breakdown.

- The window is the host annotation ``WINDOW`` around the traced steps.
- Busy: the union of the device's operations (kernels, copies, sets) inside
  the window, so overlapping operations count once.
- ``device_ops``: the device time of each operation by name, the largest
  first.
- ``idle_gaps``: each stretch inside the window in which no device
  operation ran, named by what the host was doing at its middle (the
  harness's call annotation and the innermost host operation there), the
  seconds summed by name, the largest first.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

WINDOW = "nufftbench.window"
CALL_PREFIX = "nufftbench."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(events) -> dict | None:
    """``events``: the ``traceEvents`` of a trace.  Returns ``busy_s``,
    ``window_s``, ``device_ops`` and ``idle_gaps``, or None where the trace
    holds no window or no device operation in it."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") in HOST_CATEGORIES]
    if not win:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, by_name = [], defaultdict(float)
    for e in spans:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if b > a:
            dev.append((a, b))
            by_name[_short(e.get("name", "?"))] += (b - a) * 1e-6
    if not dev:
        return None
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    edge = lo
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    host = [e for e in spans if e.get("cat") in HOST_CATEGORIES and e.get("name") != WINDOW]
    starts = np.array([float(e["ts"]) for e in host])
    ends = starts + np.array([float(e["dur"]) for e in host])
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0] if len(host) else []
        calls = [i for i in inside if host[i]["name"].startswith(CALL_PREFIX)]
        inner = [i for i in inside if not host[i]["name"].startswith(CALL_PREFIX)]
        call = host[max(calls, key=lambda i: starts[i])]["name"] if calls else "between calls"
        what = call.removeprefix(CALL_PREFIX)
        if inner:
            what += " > " + host[max(inner, key=lambda i: starts[i])]["name"]
        idle[_short(what)] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def load_events(path) -> list:
    """The ``traceEvents`` of a Chrome trace file."""
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def summarise_file(path) -> dict | None:
    return summarise(load_events(path))
