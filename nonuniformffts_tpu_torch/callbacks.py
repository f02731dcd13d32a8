"""User callbacks fused into transform passes (src/plan.jl:62-164).

The container matches the JAX package's so that call sites match; the port
does not run callbacks yet (ROADMAP queue 1, item 4), and a non-empty one
raises rather than being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class NUFFTCallbacks:
    nonuniform: Optional[Callable] = None
    uniform: Optional[Callable] = None


def check_no_callbacks(callbacks: Optional[NUFFTCallbacks]) -> None:
    if callbacks is not None and (
        callbacks.nonuniform is not None or callbacks.uniform is not None
    ):
        raise NotImplementedError(
            "callbacks are not ported yet (ROADMAP queue 1, item 4)"
        )
