"""Zeroth-order modified Bessel function of the first kind, needed by the
Kaiser-Bessel window's direct evaluation (src/Kernels/kaiser_bessel.jl:
196-210).

The JAX package also carries a Chebyshev form (``besseli0_poly``) for
evaluation inside its Pallas kernels; the CUDA kernels do not evaluate the
direct mode yet (ROADMAP queue 2, K3), so only the torch function is here.
"""

from __future__ import annotations

import torch


def besseli0(x: torch.Tensor) -> torch.Tensor:
    return torch.special.i0(x)
