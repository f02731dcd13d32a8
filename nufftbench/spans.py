"""The program's own spans in a ``torch.profiler`` trace (Chrome trace
format), reduced label by label.

The program marks each of its sections while a profiler records: a host
span named ``SPAN_PREFIX`` + the section's label
(``nufft:exec_type1/(1) spreading``; ``nonuniformffts_tpu_torch/utils/
timer.py``).  For every such label whose spans start inside the harness's
window (``trace.WINDOW``), :func:`reduce` gives:

- ``count``: the number of spans;
- ``device_s``: the seconds of the device operations launched inside the
  label's spans, each operation joined to the runtime call that launched it
  by the trace's ``correlation`` id;
- ``self_device_s``: the part of ``device_s`` launched inside none of the
  label's child labels' spans (an exec's input preparation and its
  sequencing, not its stages);
- ``blocking``: the host-blocking runtime calls inside the spans: a
  stream, device or event synchronise, a synchronous ``cudaMemcpy``, and any
  copy whose device operation reads or writes pageable memory (a
  ``.item()`` reads as two: its pageable copy and its synchronise);
- ``idle_s``: the seconds inside the spans in which no device operation
  ran, and ``self_idle_s``, the part outside the child labels' spans.

A span contains its children, so a label's numbers include theirs.  The
program launches from one thread, so a launch belongs to the spans whose
host interval holds it.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from . import trace

#: The program's span names begin with this (``utils/timer.py``).
SPAN_PREFIX = "nufft:"
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                  "cudaMemcpy")
PAGEABLE = "Pageable"


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def _busy_before(merged: np.ndarray, cum: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Device-busy microseconds before each time in ``x``: ``merged`` the
    sorted, disjoint busy intervals, ``cum`` their lengths' prefix sums."""
    if not len(merged):
        return np.zeros_like(x)
    k = np.searchsorted(merged[:, 0], x, side="right")
    last = np.maximum(k - 1, 0)
    over = np.maximum(merged[last, 1] - x, 0.0)
    return np.where(k > 0, cum[last] - over, 0.0)


def _inside(starts: np.ndarray, ends: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Whether each time in ``t`` lies in one of the disjoint intervals
    ``[starts, ends]``, ``starts`` sorted."""
    if not len(starts):
        return np.zeros(len(t), dtype=bool)
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t <= ends[np.maximum(i, 0)])


def reduce(events) -> dict:
    """``events``: the ``traceEvents`` of a trace.  Returns ``{span name:
    {count, device_s, self_device_s, blocking, idle_s, self_idle_s}}`` for
    the program's spans that start inside the window; empty where the trace
    holds no window or no such span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == trace.WINDOW
           and e.get("cat") in trace.HOST_CATEGORIES]
    if not win:
        return {}
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    by_label = defaultdict(list)
    for e in xs:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and name.startswith(SPAN_PREFIX)
                and lo <= float(e["ts"]) <= hi):
            by_label[name].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if not by_label:
        return {}

    device = [e for e in xs if e.get("cat") in trace.DEVICE_CATEGORIES]
    dev_s, pageable = defaultdict(float), set()
    for e in device:
        c = _correlation(e)
        if c is None:
            continue
        dev_s[c] += float(e["dur"]) * 1e-6
        if PAGEABLE in e.get("name", ""):
            pageable.add(c)
    merged = np.array(trace._merge(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device), dtype=float)
    merged = merged.reshape(-1, 2)
    cum = np.cumsum(merged[:, 1] - merged[:, 0])

    calls = sorted((e for e in xs if e.get("cat") in RUNTIME_CATEGORIES),
                   key=lambda e: float(e["ts"]))
    t_call = np.array([float(e["ts"]) for e in calls])
    call_dev = np.array([dev_s.get(_correlation(e), 0.0) for e in calls])
    call_blocks = np.array([e.get("name") in BLOCKING_CALLS or _correlation(e) in pageable
                            for e in calls], dtype=bool)

    spans = {}
    for name, ivs in by_label.items():
        iv = np.array(sorted(ivs))
        a, b = iv[:, 0], iv[:, 1]
        held = _inside(a, b, t_call)
        busy = _busy_before(merged, cum, b) - _busy_before(merged, cum, a)
        spans[name] = {"count": len(iv), "device_s": float(call_dev[held].sum()),
                       "blocking": int(call_blocks[held].sum()),
                       "idle_s": float(((b - a) - busy).sum()) * 1e-6,
                       "_held": held}
    for name, s in spans.items():
        kids = [k for k in spans if k.startswith(name + "/") and "/" not in k[len(name) + 1:]]
        in_kid = np.zeros(len(t_call), dtype=bool)
        kid_idle = 0.0
        for k in kids:
            in_kid |= spans[k]["_held"]
            kid_idle += spans[k]["idle_s"]
        s["self_device_s"] = float(call_dev[s["_held"] & ~in_kid].sum())
        s["self_idle_s"] = s["idle_s"] - kid_idle
    for s in spans.values():
        del s["_held"]
    return dict(sorted(spans.items()))


def reduce_file(path) -> dict:
    with open(path) as f:
        return reduce(json.load(f).get("traceEvents", []))
