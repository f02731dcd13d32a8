"""Direct NUDFT: the exact type-1 / type-2 sums as dense factor products,
with no grid, window, FFT or deconvolution.

Counterpart of ``nonuniformffts_tpu/ops/direct.py``.  For point sets small
enough that the blocked pipeline's grid-sized floor (two oversampled FFTs
and the deconvolution passes) costs more than the sums themselves, the sums

    type 1:  u(k) = sum_j v_j e^{-i k.x_j}
    type 2:  v_j  = sum_k u(k) e^{+i k.x_j}

are contracted as factor matrices: a per-dimension ``(Np, N_d)`` phase
factor, dims 1..D-1 combined into one ``(Np, prod N_d)`` tail factor, and
one matrix product against the first dim's factor times the values.

- **Phases.** ``k * x`` is formed in float64, and float64 cos/sin reduce
  it mod 2pi exactly: with |k| up to N/2 and x up to 2pi, float32 phases
  would carry ``k x 2^-24`` radians of noise.  The JAX package's float32
  split-product reduction is exact only for kmax up to ~2608 (ROADMAP F1);
  this has no such limit.  (A reduction by the float64 value of 2pi before
  cos/sin would add ``n * 2.4e-16`` rad at ``n`` turns: 1.3e-10 at
  k = 2^19, which put err1 at 4.6e-11 on a 2^20 complex128 plan.)
- **Precision.** The factors and their product are complex128 for every
  plan, and the result is cast to the plan's dtype.  The product reduces
  over Np (type 1) or over ``prod N_1..`` modes (type 2, 65,536 at 256^3 and
  2^20 in 1D) in one chain, where float32 sums would lose ``2^-24
  sqrt(K)``-order accuracy, and a float64 product is out of reach of
  TF32, whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
- **Memory.** The points are taken in chunks so that one chunk's factors
  stay under ``FACTOR_BYTES``; type 1 accumulates over chunks, type 2
  writes each chunk's points.  ``DIRECT_CHUNKS`` counts the chunks run in
  this process, by exec; ``reset_chunk_counts`` zeros it.
- **Tracing.** Each chunk's factor build runs in the section ``phase
  factors`` and its contraction in ``product`` (``utils/timer.py:traced``,
  nested in the exec's ``(1) direct NUDFT``): a plan's timer's sections,
  and profiler spans while a profiler records.  Tracing off, each costs a
  flag read; the arithmetic is the same either way.

Real-data plans use the halved last axis (k = 0 .. N/2) and, in type 2,
the doubling weights of the c2r convention (1 at k = 0, 2 beyond).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.timer import traced

#: Byte budget of one point chunk's factors.
FACTOR_BYTES = 1 << 30
#: dtype of the factors and of their product.
FACTOR_DTYPE = torch.complex128

#: ``c`` of the crossover model by (dimension, bytes of a real scalar):
#: ``spread_method='auto'`` with ``np_hint`` picks the direct path on CUDA
#: where ``direct_macs(np_hint, spectral_shape) < c *
#: blocked_dft_macs(shape_over)``.  Measured on an NVIDIA H100 80GB HBM3 at
#: 700 W (``chip_probe.py --direct``, exec_type1 + exec_type2 at 256^3,
#: 4096^2 and 2^20 with complex64 / complex128; PERF.md section 6).
DIRECT_MAC_RATIO = {(3, 4): 0.17, (3, 8): 0.35, (2, 4): 0.013, (2, 8): 0.036,
                    (1, 4): 1.6e-6, (1, 8): 1.6e-6}


def direct_macs(np_pts: int, spectral_shape) -> float:
    """Real MACs for ONE direct transform (4 real dots of the big factor)."""
    return 4.0 * np_pts * float(np.prod(spectral_shape, dtype=np.float64))


def blocked_dft_macs(shape_over) -> float:
    """Real-MAC estimate of ONE grid-sized matmul-DFT pass (the low-density
    floor the direct path competes with): sum_d 4 * prod(shape_over) * L_d."""
    total = float(np.prod(shape_over, dtype=np.float64))
    return 4.0 * total * float(sum(shape_over))


def prefers_direct(np_hint: int, spectral_shape, shape_over, real_dtype) -> bool:
    """The crossover model: is the direct path the cheaper one on CUDA?"""
    c = DIRECT_MAC_RATIO[len(shape_over), torch.finfo(real_dtype).bits // 8]
    return direct_macs(np_hint, spectral_shape) < c * blocked_dft_macs(shape_over)


def _phase_factor(k: torch.Tensor, x: torch.Tensor, sign: float) -> torch.Tensor:
    """``(Np, N)`` factor ``e^{sign i k x}`` from float64 ``k`` and ``x``."""
    p = torch.outer(x, k)
    rdt = FACTOR_DTYPE.to_real()
    return torch.complex(torch.cos(p).to(rdt), (sign * torch.sin(p)).to(rdt))


def _factors(plan, x: torch.Tensor, sign: float):
    """The first dim's ``(Np, N_0)`` factor and the tail factor ``(Np,
    N_1 * .. * N_{D-1})`` (``None`` in 1D) of the points ``x`` (D, Np)."""
    f0 = _phase_factor(plan.kvec[0], x[0], sign)
    tail = None
    for d in range(1, plan.ndim):
        g = _phase_factor(plan.kvec[d], x[d], sign)
        tail = g if tail is None else (tail[:, :, None] * g[:, None, :]).reshape(len(g), -1)
    return f0, tail


#: Point chunks run in this process, by exec.
DIRECT_CHUNKS = {"exec_type1": 0, "exec_type2": 0}


def reset_chunk_counts() -> None:
    """Zero ``DIRECT_CHUNKS``."""
    for name in DIRECT_CHUNKS:
        DIRECT_CHUNKS[name] = 0


def _chunks(plan, C: int):
    """Point ranges whose factors (the tail and C first-dim rows a point)
    fit ``FACTOR_BYTES``."""
    spec = plan.spectral_shape
    ntail = math.prod(spec[1:])
    itemsize = torch.empty((), dtype=FACTOR_DTYPE).element_size()
    step = max(1, FACTOR_BYTES // (itemsize * (ntail + C * spec[0])))
    np_ = plan.num_points
    return [(s, min(s + step, np_)) for s in range(0, np_, step)]


def exec_type1_direct(plan, vp: torch.Tensor) -> torch.Tensor:
    """``vp`` (C, Np) of the plan's dtype -> ``(C,) + spectral_shape`` of
    ``plan.complex_dtype``."""
    C = vp.shape[0]
    spec = plan.spectral_shape
    v = vp.to(FACTOR_DTYPE)
    u = torch.zeros((C * spec[0], math.prod(spec[1:])), dtype=FACTOR_DTYPE,
                    device=vp.device)
    for s, e in _chunks(plan, C):
        f0, tail = traced(plan.timer, "phase factors", _factors, plan, plan.points[:, s:e], -1.0)
        traced(plan.timer, "product", _product1, u, v[:, s:e], f0, tail)
        DIRECT_CHUNKS["exec_type1"] += 1
    return u.reshape((C,) + spec).to(plan.complex_dtype)


def _product1(u: torch.Tensor, v: torch.Tensor, f0: torch.Tensor, tail) -> torch.Tensor:
    """Adds one chunk's sums into ``u`` (C * N_0, prod N_1..) from its
    values ``v`` (C, Np_chunk) and factors; returns ``u``."""
    C, n = v.shape
    if tail is None:
        return u.view(C, -1).addmm_(v, f0)
    # (C, N_0, Np_chunk) left factor v_j e^{-i k_0 x_0j}, rows (c, k_0).
    lhs = f0.T[None] * v[:, None, :]
    return u.addmm_(lhs.reshape(-1, n), tail)


def exec_type2_direct(plan, uhat: torch.Tensor) -> torch.Tensor:
    """``uhat`` (C,) + spectral_shape -> (C, Np) of the plan's dtype (real
    parts on real-data plans)."""
    C = uhat.shape[0]
    spec = plan.spectral_shape
    u = uhat.to(FACTOR_DTYPE)
    if plan.is_real:
        # Halved last axis: the stored k > 0 modes stand for k and -k.
        w = torch.full((spec[-1],), 2.0, dtype=FACTOR_DTYPE.to_real(), device=u.device)
        w[0] = 1.0
        u = u * w
    u = u.reshape(C, spec[0], -1)
    if plan.ndim == 1:
        rhs = u[:, :, 0].T  # (N_0, C)
    else:
        # (prod N_1.., C * N_0): each column one (c, k_0) pair.
        rhs = u.permute(2, 0, 1).reshape(u.shape[2], C * spec[0])
    out = torch.empty((C, plan.num_points), dtype=FACTOR_DTYPE, device=u.device)
    for s, e in _chunks(plan, C):
        g0, tail = traced(plan.timer, "phase factors", _factors, plan, plan.points[:, s:e], 1.0)
        traced(plan.timer, "product", _product2, out[:, s:e], rhs, g0, tail)
        DIRECT_CHUNKS["exec_type2"] += 1
    return (out.real if plan.is_real else out).to(plan.dtype)


def _product2(out: torch.Tensor, rhs: torch.Tensor, g0: torch.Tensor, tail) -> torch.Tensor:
    """Writes one chunk's sums into ``out`` (C, Np_chunk) from ``rhs``
    (see ``exec_type2_direct``) and the chunk's factors; returns ``out``."""
    if tail is None:
        out.copy_((g0 @ rhs).T)
    else:
        m = (tail @ rhs).view(len(g0), out.shape[0], -1)
        out.copy_((g0[:, None, :] * m).sum(-1).T)
    return out
