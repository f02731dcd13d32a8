"""The least time the card could take for the exact sums of a direct-path
cell (``spread_method='direct'``), from its shapes alone.

The count is of the sums, whatever computes them: it reads nothing of a
plan (its point chunks, factors or products), so a later design that moves
work is still divided into the same bound.

- Bytes, a transform of a type: the user's values, the float64 coordinates
  and the spectrum (the modes at the value type's complex width), each once.
- Operations, a transform of a type: one complex multiply-add, 8 real
  operations, for each (point, mode) pair over the spectral shape.
- Peaks: ``roofline.bound_s`` takes the larger of the two times at
  ``roofline.py``'s (the NVIDIA H100 SXM's HBM3 and its FP64 tensor cores'
  67 TFLOP/s).
"""

from __future__ import annotations

import math

from .roofline import COORD_BYTES
from .shapes import Shapes, VALUE_TYPES

#: Real operations of one complex multiply-add.
CMAC_FLOPS = 8


def sums_work(s: Shapes) -> tuple:
    """(bytes, operations) of one type's exact sums over a call's
    ``ntransforms`` transforms; type 1 and type 2 count the same."""
    modes = math.prod(s.spectral_shape)
    complex_bytes = 2 * VALUE_TYPES[s.dtype][0]
    nbytes = (s.ntransforms * s.num_points * s.value_bytes + s.ndim * s.num_points * COORD_BYTES
              + s.ntransforms * modes * complex_bytes)
    return nbytes, float(CMAC_FLOPS) * s.ntransforms * s.num_points * modes
