"""The shapes of a cell, from its configuration and traffic files alone.

Plain arithmetic shared by the traffic generator, the roofline and the
reference.  It imports nothing of the program under test: the oversampled
grid follows NonuniformFFTs.jl's published rule (src/plan.jl, ``nextprod``
of 2, 3 and 5 above sigma N; a real-data plan's halved last axis is made
even), which is what the configuration states, not what a plan reports.
"""

from __future__ import annotations

import dataclasses
import math

#: Value types by name: (bytes of a real scalar, scalars a value).
VALUE_TYPES = {
    "complex64": (4, 2),
    "complex128": (8, 2),
    "float32": (4, 1),
    "float64": (8, 1),
}


def next_smooth(n: int) -> int:
    """Smallest integer >= n whose only prime factors are 2, 3 and 5."""
    m = max(1, n)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def oversampled_grid(shape, sigma: float, real: bool) -> tuple:
    """The oversampled grid of a plan of ``shape`` at ``sigma``."""
    out = []
    for d, n in enumerate(shape):
        if real and d == len(shape) - 1:
            out.append(2 * next_smooth(int(math.floor(sigma * ((n + 1) // 2)))))
        else:
            out.append(next_smooth(int(math.floor(sigma * n))))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Everything the roofline and the generator need of a cell."""

    shape: tuple  # uniform grid
    grid_over: tuple  # oversampled grid
    dtype: str  # value type of the non-uniform data
    m: int
    num_points: int
    ntransforms: int
    kernel: str
    evalmode: str

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def real(self) -> bool:
        return VALUE_TYPES[self.dtype][1] == 1

    @property
    def value_bytes(self) -> int:
        sb, ncomp = VALUE_TYPES[self.dtype]
        return sb * ncomp

    @property
    def spectral_shape(self) -> tuple:
        """The user's spectrum a transform: the last axis halved on
        real-data plans (k = 0 .. N/2)."""
        if self.real:
            return self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        return self.shape


def num_points(config: dict, traffic: dict) -> int:
    """Points of a mix on a configuration: ``density`` points per node of
    the uniform grid, rounded (NonuniformFFTs.jl's rho)."""
    return int(round(traffic["density"] * math.prod(config["shape"])))


def shapes_of(config: dict, traffic: dict) -> Shapes:
    shape = tuple(int(n) for n in config["shape"])
    real = VALUE_TYPES[config["dtype"]][1] == 1
    return Shapes(
        shape=shape,
        grid_over=oversampled_grid(shape, float(config["sigma"]), real),
        dtype=config["dtype"],
        m=int(config["m"]),
        num_points=num_points(config, traffic),
        ntransforms=int(traffic.get("ntransforms", 1)),
        kernel=config["kernel"],
        evalmode=config["kernel_evalmode"],
    )
