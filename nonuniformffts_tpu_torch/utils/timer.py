"""Per-stage timer, the analogue of the reference's TimerOutputs integration
(src/plan.jl:282-286, src/NonuniformFFTs.jl:157-185).

A plan built with ``timer=Timer(...)`` runs ``set_points`` and each stage
of ``exec_type1`` / ``exec_type2`` inside a labelled section.  CUDA launches
return before the card finishes, so with ``synchronise=True`` each section
waits for its result's device (``torch.cuda.synchronize``) before it stops
its clock, the analogue of ``KA.synchronize`` in src/plan.jl:453-454;
without it the sections measure the host's enqueue time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


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
