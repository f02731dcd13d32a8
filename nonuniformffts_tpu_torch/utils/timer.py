"""Per-stage timer, the analogue of the reference's TimerOutputs integration
(src/plan.jl:282-286, src/NonuniformFFTs.jl:157-185).

A plan built with ``timer=Timer(...)`` runs ``set_points`` and each stage
of ``exec_type1`` / ``exec_type2`` inside a labelled section.  CUDA launches
return before the card finishes, so with ``synchronise=True`` each section
waits for its result's device (``torch.cuda.synchronize``) before it stops
its clock, the analogue of ``KA.synchronize`` in src/plan.jl:453-454;
without it the sections measure the host's enqueue time.

The program opens every section through :func:`section` or :func:`traced`.
Each also marks its section in a ``torch.profiler`` trace while a profiler
records: a ``record_function`` span named ``SPAN_PREFIX`` + the section's
full label (``nufft:exec_type1/(1) spreading``), built from a stack the
helpers keep, so the trace carries the labels a ``Timer`` would record, with
or without one.  The spans are events of the profiler's own trace, on the
clock of its device operations.  With neither a timer nor a profiler the
helpers read one flag and do nothing else: no span object, no stack entry,
no clock.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _autograd_profiler

#: Prefix of the program's span names in a profiler trace.
SPAN_PREFIX = "nufft:"
_OFF = contextlib.nullcontext()


class _Labels(threading.local):
    """The names of the sections open on a thread, outermost first."""

    def __init__(self):
        self.stack = []


_labels = _Labels()


def _cuda_devices(value) -> set:
    """The CUDA devices ``value`` lives on: a tensor's, each item's of a
    tuple or list, or an object's ``device`` attribute (a plan's)."""
    if isinstance(value, (tuple, list)):
        return set().union(*map(_cuda_devices, value)) if value else set()
    dev = getattr(value, "device", None)
    return {dev} if isinstance(dev, torch.device) and dev.type == "cuda" else set()


class Timer:
    def __init__(self, synchronise: bool = False):
        self.synchronise = synchronise
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self._stack = []

    @contextmanager
    def section(self, name: str):
        label = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.times[label] += time.perf_counter() - t0
            self.counts[label] += 1

    def sync(self, value):
        """Wait for the CUDA devices of ``value`` if synchronisation is
        enabled; returns ``value``.  CPU tensors need no wait."""
        if self.synchronise:
            for dev in _cuda_devices(value):
                torch.cuda.synchronize(dev)
        return value

    def reset(self):
        self.times.clear()
        self.counts.clear()

    def __repr__(self):
        lines = ["Timer:"]
        for label in sorted(self.times, key=self.times.get, reverse=True):
            lines.append(
                f"  {label:<40s} {self.times[label] * 1e3:10.3f} ms"
                f"  ({self.counts[label]} calls)"
            )
        return "\n".join(lines)


def _tracing(timer) -> bool:
    """Whether a section is to be kept: a timer is attached or a profiler
    records."""
    return timer is not None or _autograd_profiler._is_profiler_enabled


@contextmanager
def _span(timer, name: str):
    stack = _labels.stack
    stack.append(name)
    try:
        with contextlib.ExitStack() as inner:
            if _autograd_profiler._is_profiler_enabled:
                inner.enter_context(
                    torch.profiler.record_function(SPAN_PREFIX + "/".join(stack)))
            if timer is not None:
                inner.enter_context(timer.section(name))
            yield
    finally:
        stack.pop()


def section(timer, name: str):
    """The program's section ``name`` (nested in the sections open on this
    thread): ``timer``'s section when one is given, and a profiler span
    while a profiler records."""
    return _span(timer, name) if _tracing(timer) else _OFF


def traced(timer, name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside :func:`section` ``name``, synchronised
    on the result when ``timer`` is."""
    if not _tracing(timer):
        return fn(*args, **kwargs)
    with _span(timer, name):
        out = fn(*args, **kwargs)
        return out if timer is None else timer.sync(out)
