"""Zeroth-order modified Bessel function of the first kind, needed by the
Kaiser-Bessel window's direct evaluation (src/Kernels/kaiser_bessel.jl:
196-210).

The JAX package also carries a Chebyshev form (``besseli0_poly``) for
evaluation inside its Pallas kernels, because Mosaic cannot lower a Bessel
primitive.  The CUDA kernels call the CUDA math library's
``cyl_bessel_i0f`` / ``cyl_bessel_i0`` (``csrc/window.cuh``); this torch
function is their plain twin.
"""

from __future__ import annotations

import torch


def besseli0(x: torch.Tensor) -> torch.Tensor:
    return torch.special.i0(x)
