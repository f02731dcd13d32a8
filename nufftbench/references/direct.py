"""Plain reference of a configuration on the direct path: the exact sums

    type 1:  uhat(k) = sum_j v_j exp(-i k . x_j)
    type 2:  v_j     = sum_k uhat(k) exp(+i k . x_j)

over every output mode, in float64 coordinates and complex128 sums, with
no window, grid or FFT.  The modes are the output layout of
``references/nufft.py``: FFTW order a dimension (``fftfreq``), the first
dimension slowest.

Its formulation is not the program's: a dimension's phases are
``torch.polar`` of float64 angles, folded into [0, 2 pi) here, and the sums
are contracted over the point axis with the last dimension taken apart
first (type 1: the leading dimensions' phases times the values, against the
last dimension's phases; type 2: the spectrum against the last dimension's
phases, then each leading dimension reduced in turn, last to first).  The
points are taken in chunks whose largest temporary stays near
``CHUNK_ELEMENTS`` complex128 elements.

Complex values only.  It imports numpy and torch only, and takes nothing
from the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
#: Elements of a chunk's largest temporary: (points, modes of all but the
#: last dimension), 256 MiB in complex128.
CHUNK_ELEMENTS = 1 << 24


class Reference:
    """The exact sums of one configuration on one device."""

    def __init__(self, config: dict, device):
        if config["dtype"] not in ("complex64", "complex128"):
            raise NotImplementedError(
                "exact sums of real data need the halved last axis (k = 0 .. N/2, "
                "doubled in type 2), which this reference does not have")
        self.shape = tuple(int(n) for n in config["shape"])
        self.device = torch.device(device)
        self.k = [torch.as_tensor(np.fft.fftfreq(n, 1.0 / n), dtype=torch.float64,
                                  device=self.device) for n in self.shape]
        lead = math.prod(self.shape[:-1])
        self.step = max(1, CHUNK_ELEMENTS // lead)
        # float64 products on the card stay float64; TF32 is for float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _phases(self, x: torch.Tensor, sign: float) -> list:
        """A dimension's (P, N_d) phases ``exp(sign i k_d x_d)`` of the
        chunk's points ``x`` (D, P)."""
        out = []
        for xd, kd in zip(x, self.k):
            angle = torch.outer(torch.remainder(xd, TWO_PI), kd)
            out.append(torch.polar(torch.ones_like(angle), sign * angle))
        return out

    def _chunks(self, points: torch.Tensor):
        pts = points.to(device=self.device, dtype=torch.float64)
        for s in range(0, pts.shape[1], self.step):
            yield s, pts[:, s:s + self.step]

    def type1(self, points: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """(D, Np) coordinates and (C, Np) values -> (C,) + shape, complex128."""
        v = values.to(device=self.device, dtype=torch.complex128)
        C = v.shape[0]
        out = torch.zeros((C * math.prod(self.shape[:-1]), self.shape[-1]),
                          dtype=torch.complex128, device=self.device)
        for s, x in self._chunks(points):
            e = self._phases(x, -1.0)
            a = v[:, s:s + x.shape[1]].T  # (P, C)
            for ed in e[:-1]:
                a = (a[:, :, None] * ed[:, None, :]).reshape(len(ed), -1)
            out += a.T @ e[-1]
        return out.reshape((C,) + self.shape)

    def type2(self, points: torch.Tensor, spectrum: torch.Tensor) -> torch.Tensor:
        """(D, Np) coordinates and (C,) + shape -> (C, Np), complex128."""
        u = spectrum.to(device=self.device, dtype=torch.complex128)
        C = u.shape[0]
        u = u.reshape(-1, self.shape[-1])
        out = torch.empty((C, points.shape[1]), dtype=torch.complex128, device=self.device)
        for s, x in self._chunks(points):
            e = self._phases(x, 1.0)
            t = u @ e[-1].T  # (C * N_0 .. N_{D-2}, P)
            for ed in reversed(e[:-1]):
                t = (t.view(-1, ed.shape[1], ed.shape[0]) * ed.T[None]).sum(1)
            out[:, s:s + x.shape[1]] = t
        return out
