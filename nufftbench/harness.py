"""One run of one cell: set-up, the measured window, the traced window and
the check of the timed outputs against the plain reference.

Everything a cell is made of is found by name:

- ``BENCHMARK.json``'s ``workloads`` entry names a configuration and a
  traffic mix;
- ``configs/<config>.json`` holds the configuration's sizes, window and
  value type, and names its plain reference, ``references/<reference>.py``;
- ``traffic/<traffic>.json`` holds the mix's parameters, which
  ``traffic.py`` reads;
- ``limits/<cell>.json`` holds the limits of the numbers compared and the
  readings they were set from;
- ``metrics/<metric>.py`` reads one metric from a run's ``Record``, for
  every metric of ``BENCHMARK.json`` that the cell reports.

A step is the mix's calls through the program's public API:
``set_points`` on the step's points (moving mixes), then each of
``execs``, then ``torch.cuda.synchronize()``; a mix with ``nchunks`` above
1 makes them ``set_points_chunked`` and ``exec_type{1,2}_chunked`` on a
``ChunkedPlanNUFFT``.  The window runs steps for the given seconds.  With
``trace`` the window is split: a short stretch under ``torch.profiler``
(the device's busy time and the breakdown), then the rest on a plan built
with ``Timer(synchronise=True)`` (the program's own stage spans).  The
profiled stretch's trace events stay in the ``Record`` for the readers
that take a metric from the trace.

The check: two steps of the window are compared with the reference, one
drawn from the seed among the window's first ``EARLY_STEPS`` (of the timed
part, in a traced run) and the window's last.  The first step's outputs are copied to the host when it
ends; the last step's are held.  Once the window has closed and the peak is
read, the program's state is freed and the reference computes both steps
from the same coordinates, values and spectrum.  The numbers compared are
the relative L2 gaps of the whole type-1 spectrum and of every type-2
value, the larger over the two steps, each against its limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import random
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import trace as tracing
from .shapes import Shapes
from .traffic import TORCH_DTYPES, Traffic

HERE = Path(__file__).resolve().parent
WARMUP_STEPS = 3
EARLY_STEPS = 8
#: The traced stretch under the profiler: this share of the window, at
#: most ``PROFILE_SECONDS``, after ``PROFILE_WARMUP`` steps outside it.
PROFILE_SHARE, PROFILE_SECONDS, PROFILE_WARMUP = 0.25, 2.0, 2
#: The numbers compared, by the transform whose output they judge.
CHECKS = {"exec_type1": "t1_rel_l2", "exec_type2": "t2_rel_l2"}
#: The control's value type: the nearest precision below each one.
LOWER = {"complex128": "complex64", "float64": "float32"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def _load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name=name, chips=w["chips"], config=_load_json(root / cfg["file"]),
                traffic=_load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=_load_json(HERE / "limits" / f"{name}.json"))


def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"nufftbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record)``."""
    return _load_module(HERE / "metrics" / f"{name}.py").read


def reference_for(config: dict, device):
    """The configuration's plain reference, ``references/<name>.py``."""
    return _load_module(HERE / "references" / f"{config['reference']}.py").Reference(
        config, device)


@dataclasses.dataclass
class Record:
    """What a run saw, for the metric readers."""

    shapes: Shapes
    setup_s: float = float("nan")
    step_times: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0
    # the program's Timer over the timed part of a traced run
    timer_times: dict = dataclasses.field(default_factory=dict)
    timer_steps: int = 0
    # the profiled stretch of a traced run (trace.py), or None
    device: dict | None = None
    # the profiled stretch's trace events and the steps inside its window
    trace_events: list = dataclasses.field(default_factory=list)
    trace_steps: int = 0

    def per_step_s(self, *labels: str) -> float | None:
        """Seconds a timed step in the Timer's sections ``labels``
        together, or None where none of them ran."""
        found = [self.timer_times[n] for n in labels if n in self.timer_times]
        if not found or not self.timer_steps:
            return None
        return sum(found) / self.timer_steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Steps:
    """The program driven through its public API: a plan and the step.

    The mix's ``nchunks`` picks the API: 1, ``PlanNUFFT`` with
    ``set_points`` and ``exec_type{1,2}``; more, ``ChunkedPlanNUFFT`` with
    the same names ending in ``_chunked``, the same arguments otherwise."""

    def __init__(self, cell: Cell, traffic: Traffic, device, dtype: str, timer=None,
                 marks: bool = False):
        import nonuniformffts_tpu_torch as nufft

        self.nufft, self.traffic, self.device = nufft, traffic, device
        cfg = cell.config
        self.dtype = TORCH_DTYPES[dtype]
        args = (np.dtype(dtype), tuple(cfg["shape"]))
        kwargs = dict(m=cfg["m"], sigma=cfg["sigma"], kernel=getattr(nufft, cfg["kernel"])(),
                      kernel_evalmode=getattr(nufft, cfg["kernel_evalmode"])(),
                      ntransforms=traffic.shapes.ntransforms,
                      spread_method=cfg["spread_method"], device=device, timer=timer)
        self.suffix, self.exec_timer = "", None
        if traffic.nchunks == 1:
            self.plan = nufft.PlanNUFFT(*args, **kwargs)
        else:
            self.suffix = "_chunked"
            try:
                self.plan = nufft.ChunkedPlanNUFFT(*args, nchunks=traffic.nchunks, **kwargs)
            except NotImplementedError:
                # A program whose chunked plans refuse a timer: the template
                # carries it, so each chunk's set_points and every stage is
                # the timer's section, and the step opens each exec's
                # section as exec_type1 and exec_type2 open theirs.
                self.plan = nufft.ChunkedPlan(nchunks=traffic.nchunks,
                                              template=nufft.PlanNUFFT(*args, **kwargs))
                self.exec_timer = timer
        self.values = traffic.values.to(self.dtype)
        spec_dtype = torch.complex64 if self.dtype in (torch.complex64, torch.float32) \
            else torch.complex128
        self.spectrum = traffic.spectrum.to(spec_dtype)
        self.marks = marks
        if not traffic.moving:
            self.plan = self._api("set_points")(self.plan, traffic.points(0))

    def _mark(self, name: str):
        if self.marks:
            return torch.profiler.record_function(tracing.CALL_PREFIX + name)
        return contextlib.nullcontext()

    def _api(self, name: str):
        """The program's function ``name`` for this step's plan, looked up
        at the call."""
        return getattr(self.nufft, name + self.suffix)

    def _section(self, name: str):
        if self.exec_timer is not None:
            return self.exec_timer.section(name)
        return contextlib.nullcontext()

    def __call__(self, k: int) -> dict:
        out = {}
        if self.traffic.moving:
            with self._mark("points"):
                pts = self.traffic.points(k)
            with self._mark("set_points"):
                self.plan = self._api("set_points")(self.plan, pts)
        for name in self.traffic.execs:
            arg = self.values if name == "exec_type1" else self.spectrum
            with self._mark(name), self._section(name):
                out[name] = self._api(name)(self.plan, arg)
        with self._mark("synchronize"):
            _sync(self.device)
        return out


class Window:
    """Runs steps until the seconds are spent; keeps each step's time, the
    failures, and the outputs of the steps to check."""

    def __init__(self, check_index: int):
        self.check_index = check_index  # the window's step whose outputs are copied
        self.times, self.failed, self.attempted = [], 0, 0
        self.checked = {}  # step number -> outputs
        self.window_s = 0.0
        self.error = None

    def one(self, step, k: int):
        """Step ``k``; its outputs, or None where it raised (counted)."""
        self.attempted += 1
        try:
            return step(k)
        except Exception:  # a failed step counts; the run goes on
            self.failed += 1
            if self.error is None:
                self.error = traceback.format_exc()
            return None

    def run(self, step, k0: int, seconds: float, timed: bool = True) -> int:
        """Steps ``k0, k0 + 1, ..`` for ``seconds``; returns the next step
        number.  A timed run keeps each step's time, copies the outputs of
        its ``check_index``-th step to the host (the copy's time is left
        out of the window) and keeps the last step's."""
        k, out, n = k0, None, 0
        t_start = time.perf_counter()
        deadline, paused = t_start + seconds, 0.0
        while True:
            t0 = time.perf_counter()
            out = self.one(step, k)
            t1 = time.perf_counter()
            if timed:
                self.times.append(t1 - t0)
                if n == self.check_index and out is not None:
                    self.checked[k] = {name: v.to("cpu") for name, v in out.items()}
                    copy_s = time.perf_counter() - t1
                    paused += copy_s
                    deadline += copy_s
            n += 1
            k += 1
            if t1 >= deadline:
                break
        if timed:
            self.window_s += time.perf_counter() - t_start - paused
            if out is not None:
                self.checked[k - 1] = out
        return k


def _profile(step, win: Window, k0: int, seconds: float, device) -> tuple:
    """Steps under ``torch.profiler`` for ``seconds`` (the first
    ``PROFILE_WARMUP`` outside the annotated window), counted in ``win``
    but not timed; returns (next step, trace summary or None, the trace's
    events, the steps inside the window)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    k = k0
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_WARMUP):
            win.one(step, k)
            k += 1
        k_window = k
        with torch.profiler.record_function(tracing.WINDOW):
            k = win.run(step, k, seconds, timed=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = tracing.summarise_file(path)
        events = tracing.load_events(path)
    return k, summary, events, k - k_window


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got = got.to(device=want.device, dtype=want.dtype)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def check_outputs(cell: Cell, traffic: Traffic, checked: dict, device) -> dict:
    """The numbers compared: for each transform of the mix the largest
    relative L2 gap over the checked steps between the program's output
    and the reference's.  A step whose outputs never came counts as
    infinite."""
    ref = reference_for(cell.config, device)
    gaps = {CHECKS[n]: 0.0 for n in traffic.execs}
    if not checked:
        return {k: math.inf for k in gaps}
    memo = {}  # the reference's outputs, by step (one for a fixed mix) and transform
    for k, outs in sorted(checked.items()):
        for name in traffic.execs:
            key = (k if traffic.moving else 0, name)
            if key not in memo:
                pts = traffic.points(k)
                memo[key] = (ref.type1(pts, traffic.values) if name == "exec_type1"
                             else ref.type2(pts, traffic.spectrum))
            got = outs.get(name)
            gap = math.inf if got is None else rel_l2(got, memo[key])
            gaps[CHECKS[name]] = max(gaps[CHECKS[name]], gap if math.isfinite(gap) else math.inf)
        if traffic.moving:
            memo.clear()
    return gaps


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, dtype: str | None = None) -> dict:
    """One run.  Returns the result's fields: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (without the card's name), and
    ``breakdown`` and ``checks``.  ``dtype`` replaces the configuration's
    value type (the control)."""
    device = torch.device(device)
    t_start = time.perf_counter() if t_start is None else t_start
    dtype = dtype or cell.config["dtype"]
    phases = {"start": time.perf_counter() - t_start}
    traffic = Traffic(cell.config, cell.traffic, seed, device)
    _sync(device)
    phases["inputs"] = time.perf_counter() - t_start
    rec = Record(shapes=traffic.shapes)
    win = Window(random.Random(seed).randrange(EARLY_STEPS))
    k = 0
    if not trace:
        step = Steps(cell, traffic, device, dtype)
        _sync(device)
        phases["plan"] = time.perf_counter() - t_start
        for _ in range(WARMUP_STEPS):
            step(k)
            k += 1
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        rec.setup_s = phases["warmup"] = time.perf_counter() - t_start
        win.run(step, k, seconds)
        del step
    else:
        import nonuniformffts_tpu_torch as nufft

        plain = Steps(cell, traffic, device, dtype, marks=True)
        timer = nufft.Timer(synchronise=True)
        timed = Steps(cell, traffic, device, dtype, timer=timer)
        _sync(device)
        phases["plan"] = time.perf_counter() - t_start
        for _ in range(WARMUP_STEPS):
            plain(k)
            timed(k + 1)
            k += 2
        timer.reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        rec.setup_s = phases["warmup"] = time.perf_counter() - t_start
        t_prof = min(PROFILE_SECONDS, PROFILE_SHARE * seconds)
        k, rec.device, rec.trace_events, rec.trace_steps = _profile(plain, win, k, t_prof,
                                                                    device)
        del plain
        win.run(timed, k, seconds - t_prof)
        rec.timer_times = dict(timer.times)
        rec.timer_steps = len(win.times)
        del timed
    rec.step_times, rec.window_s = win.times, win.window_s
    if device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check_outputs(cell, traffic, win.checked, device)
    t_check = time.perf_counter() - t_check
    limits = cell.limits["limits"]
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(spec["name"])(rec)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    correct = (win.failed == 0 and len(win.checked) >= 1
               and all(checks[n] <= limits[n] for n in checks))
    result = {
        "correct": bool(correct),
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": {"count": 1, "memory_peak_bytes": int(rec.peak_bytes)},
        "error": win.error,
        "run": {"steps": len(win.times), "window_s": win.window_s,
                "checked_steps": sorted(win.checked), "check_s": t_check, "setup": phases},
        "checks": {n: {"value": checks[n], "limit": limits[n]} for n in checks},
    }
    if trace and rec.device is not None:
        result["device"]["busy_s"] = rec.device["busy_s"]
        result["device"]["window_s"] = rec.device["window_s"]
        result["breakdown"] = {"device_ops": rec.device["device_ops"],
                               "idle_gaps": rec.device["idle_gaps"]}
    return result
