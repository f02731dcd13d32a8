"""The one generator of every traffic mix: a mix file's parameters, a
configuration and a seed in, the inputs of every step out, made on the
device in a few large calls.

A mix file (``traffic/<name>.json``) holds:

- ``density``: points per node of the uniform grid (NonuniformFFTs.jl's
  rho); the points are uniform in [0, 2 pi)^D;
- ``motion``: ``"moving"`` (every step calls ``set_points`` on points
  moved by a displacement fixed in set-up, ``x_k = x_0 + k d``, which
  leaves [0, 2 pi) and is folded by the program) or ``"fixed"`` (the points
  are set once in set-up);
- ``max_displacement_cells``: the largest displacement a step, in cells of
  the uniform grid, each axis uniform in [-max, max] (moving mixes);
- ``execs``: the transforms a step runs, in order, from ``exec_type1`` and
  ``exec_type2``;
- ``ntransforms``: transforms a call over the shared points;
- ``nchunks`` (1 where absent): the slices of the points a plan runs.  At
  1 a step runs ``PlanNUFFT`` through ``set_points`` and
  ``exec_type{1,2}``; above 1, ``ChunkedPlanNUFFT`` with that many chunks
  through ``set_points_chunked`` and ``exec_type{1,2}_chunked``, on the same
  points, values and spectrum.  A user picks it for the number of points,
  so it sits beside ``density``.

Every seed gives the same sizes; the seed changes only the draws.  The
values (the configuration's value type) and the type-2 spectrum (complex,
the configuration's spectral shape) are drawn once in set-up.
"""

from __future__ import annotations

import math

import torch

from .shapes import Shapes, shapes_of

TWO_PI = 2.0 * math.pi
TORCH_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128,
                "float32": torch.float32, "float64": torch.float64}
EXECS = ("exec_type1", "exec_type2")


def seed_state(seed: int) -> int:
    """Any whole number as a generator seed (``manual_seed`` takes 64 bits)."""
    return int(seed) % (1 << 63)


class Traffic:
    """The inputs of a cell's steps for one seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.shapes: Shapes = shapes_of(config, traffic)
        self.moving = traffic["motion"] == "moving"
        if traffic["motion"] not in ("moving", "fixed"):
            raise ValueError(f"unknown motion {traffic['motion']!r}")
        self.execs = tuple(traffic["execs"])
        if not self.execs or any(e not in EXECS for e in self.execs):
            raise ValueError(f"execs must be drawn from {EXECS}, got {self.execs}")
        self.nchunks = int(traffic.get("nchunks", 1))
        if self.nchunks < 1:
            raise ValueError(f"nchunks must be at least 1, got {self.nchunks}")
        s = self.shapes
        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(seed_state(seed))
        D, npts, C = s.ndim, s.num_points, s.ntransforms
        self.x0 = torch.rand((D, npts), generator=gen, dtype=torch.float64, device=dev) * TWO_PI
        self.disp = None
        if self.moving:
            cells = torch.tensor([TWO_PI / n for n in s.shape], dtype=torch.float64, device=dev)
            amp = float(traffic["max_displacement_cells"]) * cells[:, None]
            self.disp = (torch.rand((D, npts), generator=gen, dtype=torch.float64, device=dev)
                         * 2.0 - 1.0) * amp
        self.values = torch.randn((C, npts), generator=gen, dtype=TORCH_DTYPES[s.dtype],
                                  device=dev)
        self.spectrum = torch.randn((C,) + s.spectral_shape, generator=gen,
                                    dtype=torch.complex128, device=dev)

    def points(self, step: int) -> torch.Tensor:
        """(D, Np) float64 coordinates of step ``step``: ``x_0 + step d``,
        unfolded, on a moving mix; ``x_0`` on a fixed one."""
        if not self.moving:
            return self.x0
        return torch.add(self.x0, self.disp, alpha=float(step))
