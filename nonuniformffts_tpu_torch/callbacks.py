"""User callbacks applied around the transform passes (src/plan.jl:62-164).

Counterpart of ``nonuniformffts_tpu/callbacks.py``, with the same
semantics:

- ``nonuniform(v, n)``: applied to non-uniform values; ``v`` is a tuple of
  C tensors of shape ``(Np,)`` (one per simultaneous transform, real on
  real-data plans) and ``n`` the point index ``arange(Np)``, the global
  index in input order.  Applied to type-1 inputs before spreading and to
  type-2 outputs after interpolation.
- ``uniform(w, idx)``: applied to uniform values; ``w`` is a tuple of C
  grid tensors and ``idx`` a tuple of D index tensors, positions along
  each dim in the array's storage order, of shape ``(n_d, 1, ..)``
  broadcast against the grid.  Applied inside both deconvolution passes.

Each callback is called once, on whole tensors (a torch pass around the
kernels, written as tensor expressions); what it returns is cast back to
the data's dtype.  Transform inputs are never modified.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class NUFFTCallbacks:
    nonuniform: Optional[Callable] = None
    uniform: Optional[Callable] = None


def apply_nonuniform_callback(vp: torch.Tensor, callback) -> torch.Tensor:
    """The per-point callback on ``vp`` (C, Np)."""
    if callback is None:
        return vp
    n = torch.arange(vp.shape[1], device=vp.device)
    out = callback(tuple(vp.unbind(0)), n)
    return torch.stack([torch.broadcast_to(o, vp.shape[1:]) for o in out]).to(vp.dtype)


def apply_uniform_callback(w: torch.Tensor, callback) -> torch.Tensor:
    """The per-mode callback on ``w`` (C,) + grid shape."""
    if callback is None:
        return w
    shape = w.shape[1:]
    D = len(shape)
    idx = tuple(
        torch.arange(n, device=w.device).view([n if e == d else 1 for e in range(D)])
        for d, n in enumerate(shape)
    )
    out = callback(tuple(w.unbind(0)), idx)
    return torch.stack([torch.broadcast_to(o, shape) for o in out]).to(w.dtype)
