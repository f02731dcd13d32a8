"""Plain reference of a NUFFT configuration: the algorithm that the
configuration states, written out in float64 PyTorch with none of the
program's kernels, blocks or tables (it sorts the points by cell itself,
for the locality of its ``index_add_``).

- type 1: ``uhat(k) = sum_j v_j exp(-i k . x_j)``, approximated as
  NonuniformFFTs.jl defines it: spread each value onto the oversampled grid
  with the window's 2M taps a dimension (``index_add_``), FFT, then keep the
  output modes and divide by the window's Fourier transform times
  ``prod(2 pi / N~)``;
- type 2: ``v_j = sum_k uhat(k) exp(+i k . x_j)``: divide by the window's
  transform, zero-pad, inverse FFT without normalisation, and gather each
  point's 2M taps a dimension times ``prod(2 pi / N~)``.

Real-data configurations (float64 values) take the halved last axis
``k = 0 .. N/2`` (rfft layout): type 1 is ``rfftn``, type 2 ``irfftn``,
whose c2r pass doubles every stored ``k > 0`` of that axis and keeps real
parts.

The window: backwards Kaiser-Bessel, whose shape parameter beta is the
published optimum (NonuniformFFTs.jl's kaiser_bessel_backwards.jl:123-136),
in FastApproximation as the reference defines it (piecewise_polynomial.jl):
on each of the 2M sub-intervals of the support the polynomial of degree
M + 3 that interpolates the window at Chebyshev nodes.  Here that
polynomial is evaluated in the Chebyshev basis by Clenshaw's recurrence,
not from monomial coefficients.  Its Fourier transform is the closed form
``w I0(sqrt(beta^2 - (w k)^2))``.  Another window goes into a reference of
its own, named by its configuration.

It imports numpy and torch only, and takes nothing from the program: the
grid, beta, the taps and the transforms are worked out here again from the
configuration's numbers.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from nufftbench.shapes import oversampled_grid

TWO_PI = 2.0 * math.pi
WINDOW = ("BackwardsKaiserBesselKernel", "FastApproximation")
#: Points a block: a block's (points, 2M) index, weight and value tensors
#: stay near 2^25 elements each.
BLOCK_ELEMENTS = 1 << 25


def optimal_beta(m: int, sigma: float) -> float:
    """The backwards Kaiser-Bessel window's published optimum."""
    a = m * (2.0 - 1.0 / sigma)
    return math.pi * a * max(0.995, math.sqrt(1.0 - 0.3 / a**2))


def window_exact(beta: float, y: np.ndarray) -> np.ndarray:
    """The backwards Kaiser-Bessel window ``sinh(beta s) / (pi s)``,
    ``s = sqrt(1 - y^2)``, at normalised distances ``y`` in [-1, 1]."""
    s = np.sqrt(np.clip(1.0 - y * y, 0.0, None))
    bs = beta * s
    safe = np.where(bs == 0.0, 1.0, bs)
    return np.where(bs == 0.0, beta / math.pi, beta * np.sinh(safe) / (math.pi * safe))


class Window:
    """One dimension's window: its taps at a point's fraction ``X`` in the
    cell, for the nodes ``c - M + 1 + t``, t = 0 .. 2M - 1, and its Fourier
    transform."""

    def __init__(self, m: int, n_over: int, sigma: float):
        self.m = m
        self.beta = optimal_beta(m, sigma)
        self.w = m * TWO_PI / n_over
        self.cheb = self._chebyshev_pieces()

    def _chebyshev_pieces(self) -> np.ndarray:
        """(2M, npoly) Chebyshev coefficients of each piece's interpolant:
        piece t covers y in [1 - (t + 1) / M, 1 - t / M], the distances of
        node t, mapped to z in [-1, 1]."""
        m, npoly = self.m, self.m + 4
        theta = math.pi * (np.arange(npoly) + 0.5) / npoly
        L = 2 * m
        out = np.empty((L, npoly))
        for t in range(L):
            f = window_exact(self.beta, 1.0 - (2 * t + 1) / L + np.cos(theta) / L)
            for k in range(npoly):
                out[t, k] = (2.0 / npoly) * np.sum(f * np.cos(k * theta))
            out[t, 0] *= 0.5
        return out

    def taps(self, X: torch.Tensor) -> torch.Tensor:
        """(P,) fractions in [0, 1) -> (P, 2M) float64 taps, by Clenshaw's
        recurrence at ``z = 2X - 1``."""
        a = torch.as_tensor(self.cheb, device=X.device)  # (2M, npoly)
        z = (2.0 * X - 1.0)[:, None]
        b1 = torch.zeros((X.shape[0], 2 * self.m), dtype=torch.float64, device=X.device)
        b2 = torch.zeros_like(b1)
        for k in range(a.shape[1] - 1, 0, -1):
            b1, b2 = a[:, k] + 2.0 * z * b1 - b2, b1
        return a[:, 0] + z * b1 - b2

    def transform(self, k: np.ndarray) -> np.ndarray:
        """``w I0(sqrt(beta^2 - (w k)^2))`` at wavenumbers ``k``; every
        output mode of the configurations here has ``|w k| < beta``."""
        q2 = self.beta**2 - (self.w * k) ** 2
        if np.any(q2 <= 0.0):
            raise ValueError("a mode lies beyond the window's main lobe")
        return self.w * np.i0(np.sqrt(q2))


class Reference:
    """The plain NUFFT of one configuration on one device."""

    def __init__(self, config: dict, device):
        self.shape = tuple(int(n) for n in config["shape"])
        self.real = config["dtype"] in ("float32", "float64")
        self.m = int(config["m"])
        self.grid = oversampled_grid(self.shape, float(config["sigma"]), self.real)
        self.device = torch.device(device)
        if (config["kernel"], config["kernel_evalmode"]) != WINDOW:
            raise ValueError(f"this reference has only the window {WINDOW}")
        self.windows = [Window(self.m, no, no / n) for n, no in zip(self.shape, self.grid)]
        self.normfactor = math.prod(TWO_PI / no for no in self.grid)
        D = len(self.shape)
        # Output wavenumbers a dimension (FFTW order; 0 .. N/2 on a real
        # plan's last axis), their rows of the oversampled spectrum, and the
        # deconvolution factors normfactor / prod_d phi_hat_d(k_d).
        self.kidx, self.deconv = [], []
        for d, (n, no, win) in enumerate(zip(self.shape, self.grid, self.windows)):
            if self.real and d == D - 1:
                k = np.arange(n // 2 + 1, dtype=np.float64)
                rows = k.astype(np.int64)
            else:
                k = np.fft.fftfreq(n, 1.0 / n)
                rows = np.where(k < 0, k + no, k).astype(np.int64)
            self.kidx.append(torch.as_tensor(rows, device=self.device))
            self.deconv.append(torch.as_tensor(1.0 / win.transform(k), device=self.device))
        self.strides = [math.prod(self.grid[d + 1:]) for d in range(D)]

    # -- point tables ------------------------------------------------------

    def _order(self, points: torch.Tensor) -> torch.Tensor:
        """The points in the order of their cells' linear index, so that
        neighbouring points of a block touch neighbouring nodes."""
        lin = torch.zeros(points.shape[1], dtype=torch.int64, device=self.device)
        for d, no in enumerate(self.grid):
            x = points[d].to(device=self.device, dtype=torch.float64)
            c = torch.remainder(torch.floor(x * (no / TWO_PI)).to(torch.int64), no)
            lin += c * self.strides[d]
        return torch.argsort(lin)

    def _blocks(self, points: torch.Tensor):
        """For each block of points: its slice, and a dimension's (P, 2M)
        linear offsets of the nodes and (P, 2M) taps."""
        npts = points.shape[1]
        step = max(1, BLOCK_ELEMENTS // (2 * self.m))
        t = torch.arange(2 * self.m, device=self.device) - (self.m - 1)
        for s in range(0, npts, step):
            x = points[:, s:s + step].to(device=self.device, dtype=torch.float64)
            offs, taps = [], []
            for d, (no, win) in enumerate(zip(self.grid, self.windows)):
                r = x[d] * (no / TWO_PI)
                i = torch.floor(r)
                X = r - i
                c = torch.remainder(i.to(torch.int64), no)
                offs.append(torch.remainder(c[:, None] + t, no) * self.strides[d])
                taps.append(win.taps(X))
            yield slice(s, s + x.shape[1]), offs, taps

    def _walk(self, offs, taps):
        """Each combination of the leading dimensions' taps: the (P, 2M)
        linear indices and weights over the last dimension's taps."""
        D = len(offs)
        for lead in itertools.product(range(2 * self.m), repeat=D - 1):
            idx, wt = offs[-1], taps[-1]
            for d, td in enumerate(lead):
                idx = idx + offs[d][:, td:td + 1]
                wt = wt * taps[d][:, td:td + 1]
            yield idx, wt

    # -- transforms --------------------------------------------------------

    def type1(self, points: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """(D, Np) coordinates and (C, Np) values -> (C,) + spectral shape,
        complex128."""
        order = self._order(points)
        points = points.to(self.device)[:, order]
        values = values.to(self.device)[:, order]
        vol = math.prod(self.grid)
        out = []
        for c in range(values.shape[0]):
            parts = [values[c].real.double()] + ([] if self.real else [values[c].imag.double()])
            grids = [torch.zeros(vol, dtype=torch.float64, device=self.device) for _ in parts]
            for sl, offs, taps in self._blocks(points):
                for idx, wt in self._walk(offs, taps):
                    flat = idx.reshape(-1)
                    for g, v in zip(grids, parts):
                        g.index_add_(0, flat, (v[sl, None] * wt).reshape(-1))
            if self.real:
                spec = torch.fft.rfftn(grids[0].reshape(self.grid))
            else:
                spec = torch.fft.fftn(torch.complex(grids[0], grids[1]).reshape(self.grid))
            del grids
            for d, (rows, dec) in enumerate(zip(self.kidx, self.deconv)):
                spec = spec.index_select(d, rows)
                spec = spec * dec.reshape([-1 if e == d else 1 for e in range(spec.ndim)])
            out.append(spec * self.normfactor)
        return torch.stack(out)

    def type2(self, points: torch.Tensor, spectrum: torch.Tensor) -> torch.Tensor:
        """(D, Np) coordinates and (C,) + spectral shape -> (C, Np), complex128
        (float64 on a real configuration)."""
        D = len(self.shape)
        npts = points.shape[1]
        order = self._order(points)
        points = points.to(self.device)[:, order]
        out = []
        for c in range(spectrum.shape[0]):
            u = spectrum[c].to(device=self.device, dtype=torch.complex128)
            for d, dec in enumerate(self.deconv):
                u = u * dec.reshape([-1 if e == d else 1 for e in range(D)])
            over = list(self.grid)
            if self.real:
                over[-1] = self.grid[-1] // 2 + 1
            padded = torch.zeros(over, dtype=torch.complex128, device=self.device)
            index = torch.meshgrid(*self.kidx, indexing="ij")
            padded[index] = u
            if self.real:
                g = torch.fft.irfftn(padded, s=self.grid, norm="forward").reshape(-1)
            else:
                g = torch.fft.ifftn(padded, norm="forward").reshape(-1)
            del padded, u
            v = torch.zeros(npts, dtype=g.dtype, device=self.device)
            for sl, offs, taps in self._blocks(points):
                acc = torch.zeros(sl.stop - sl.start, dtype=g.dtype, device=self.device)
                for idx, wt in self._walk(offs, taps):
                    acc += (g[idx] * wt).sum(dim=1)
                v[order[sl]] = acc
            out.append(v * self.normfactor)
        return torch.stack(out)
