"""Points-chunked plans: huge point sets with chunk-sized temporaries.

Counterpart of ``nonuniformffts_tpu/chunked.py``.  The reference's
benchmark protocol sweeps to rho = 10, 167.8M points on a 256^3 grid
(benchmark/CPU+CUDA/run_benchmarks.jl:394-404).  A ``ChunkedPlan`` holds
``nchunks`` ordinary plans, one for each contiguous slice of the points in
their input order (``torch.tensor_split``, so the slices may differ in
length by one), built by ``set_points`` one after another: the bin sort's
temporaries are a chunk's size, and each chunk plan shares the template's
precomputed tensors.

- type 1: each chunk is spread into a zeroed grid of its own, added into
  one accumulator grid, and one FFT and one deconvolution follow.  (Each
  chunk gets its own grid because the 1D spread kernel stores its interior
  cells rather than adding them: ``csrc/spread_1d.cu``.)  The JAX package
  sums K spectra after K FFTs instead; the two agree up to the order of
  the float sums.
- type 2: one deconvolution and one backward FFT make the grid, each chunk
  interpolates from it, and the chunks' values are concatenated.
- many transforms: both run in the chunked plan's groups of transforms
  (``ChunkedPlan.transform_chunk``, the plain plans' ``Plan.transform_chunk``
  and the JAX package's ``cr_chunk``), through ``execution.py``'s group
  loops: a group's accumulator and each chunk's grid, or a group's grid,
  at a time.  ``set_points_chunked`` chooses it on the card from the
  template with all the points, all chunks' point state and the
  accumulator (one more grid a transform); the chunk plans' own choices
  are not used.
- callbacks: the nonuniform one sees the whole value array (``n`` is the
  global point index), before the split in type 1 and after the
  concatenation in type 2; the uniform one sees every transform at once.

A direct template (``spread_method='direct'``, or ``'auto'`` with a small
``np_hint`` on CUDA) sums its chunks' exact type-1 spectra and concatenates
their type-2 values.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from . import execution as ex
from .callbacks import NUFFTCallbacks, apply_nonuniform_callback, apply_uniform_callback
from .ops.direct import exec_type1_direct, exec_type2_direct
from .plan import Plan, PlanNUFFT, canonical_points, point_state_bytes, set_points
from .plan import with_transform_chunk as _with_plan_transform_chunk


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkedPlan:
    """A NUFFT plan whose points run in ``nchunks`` slices.

    ``template`` is an ordinary :class:`Plan` built for about
    ``Np / nchunks`` points; after :func:`set_points_chunked`, ``plans``
    holds one plan with points set for each slice, in order,
    ``num_points_total`` the number of points and ``transform_chunk`` the
    transforms a pass of either exec (None: all in one pass).
    """

    nchunks: int
    template: Plan
    plans: Optional[List[Plan]] = None
    num_points_total: Optional[int] = None
    transform_chunk: Optional[int] = None

    @property
    def base(self) -> Plan:
        """The plan whose statics and shared tensors every chunk has."""
        return self.template


def ChunkedPlanNUFFT(dtype, shape, *, nchunks: int, np_hint: Optional[int] = None,
                     **kwargs) -> ChunkedPlan:
    """Construct a points-chunked plan (see :func:`PlanNUFFT` for kwargs).

    ``np_hint``, when given, is the TOTAL expected point count; the template
    is built for ``np_hint / nchunks`` points.  64-bit plans and
    ``precision='double'`` are accepted (native float64, as for
    :func:`PlanNUFFT`); a timer is not.
    """
    if nchunks < 1:
        raise ValueError(f"nchunks must be >= 1, got {nchunks}")
    if np_hint is not None:
        np_hint = -(-int(np_hint) // nchunks)
    tmpl = PlanNUFFT(dtype, shape, np_hint=np_hint, **kwargs)
    if tmpl.timer is not None:
        raise NotImplementedError("timers are not supported on chunked plans")
    return ChunkedPlan(nchunks=int(nchunks), template=tmpl)


def set_points_chunked(cplan: ChunkedPlan, points) -> ChunkedPlan:
    """Return a new chunked plan with the points set, chunk by chunk.

    ``points`` takes every format :func:`set_points` takes; chunk ``i`` is
    the ``i``-th of ``nchunks`` contiguous slices of the points in input
    order.
    """
    pts = canonical_points(cplan.template, points)
    plans = [set_points(cplan.template, p)
             for p in torch.tensor_split(pts, cplan.nchunks, dim=1)]
    return with_transform_chunk(
        dataclasses.replace(cplan, plans=plans, num_points_total=pts.shape[1]))


def with_transform_chunk(cplan: ChunkedPlan) -> ChunkedPlan:
    """``cplan`` (points set) with ``transform_chunk`` chosen for the card
    from the template's model (``plan.py:with_transform_chunk``) with all
    the points, every chunk's point state and the type-1 accumulator, one
    more grid a transform; CPU and direct plans keep theirs."""
    chosen = _with_plan_transform_chunk(
        whole_plan(cplan), point_state_bytes=sum(point_state_bytes(p) for p in cplan.plans),
        extra_grids=1)
    return dataclasses.replace(cplan, transform_chunk=chosen.transform_chunk)


def whole_plan(cplan: ChunkedPlan) -> Plan:
    """The template as a plan of all the points in the chunked plan's
    groups of transforms: the plan of the stages that see every chunk, and
    what ``set_points_chunked`` models."""
    return dataclasses.replace(cplan.template, num_points_static=cplan.num_points_total,
                               transform_chunk=cplan.transform_chunk)


def _check_set(cplan: ChunkedPlan):
    if cplan.plans is None:
        raise RuntimeError("points not set: call set_points_chunked first")


def exec_type1_chunked(cplan: ChunkedPlan, vp,
                       callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Type-1 NUFFT over chunks: ``vp`` of shape ``(Np,)`` or ``(C, Np)`` in
    the plan's dtype; the output as :func:`exec_type1`'s."""
    _check_set(cplan)
    callbacks = callbacks or NUFFTCallbacks()
    p0 = whole_plan(cplan)
    vp, had_axis = ex.prepare_type1(p0, vp)
    vp = apply_nonuniform_callback(vp, callbacks.nonuniform)
    sizes = [p.num_points for p in cplan.plans]
    if p0.spread_method == "direct":
        uhat = sum(exec_type1_direct(p, v) for p, v in zip(cplan.plans, vp.split(sizes, 1)))
        uhat = apply_uniform_callback(uhat, callbacks.uniform)
    else:
        def spread(_, v):
            # The accumulator and one chunk's grid at a time: a chunk's grid
            # goes as soon as it is added.
            parts = zip(cplan.plans, v.split(sizes, 1))
            grid = ex.t1_spread_stage(*next(parts))
            for p, vk in parts:
                grid.add_(ex.t1_spread_stage(p, vk))
            return grid

        uhat = ex.type1_groups(p0, vp, callbacks.uniform, spread)
    return uhat if had_axis else uhat[0]


def exec_type2_chunked(cplan: ChunkedPlan, uhat,
                       callbacks: NUFFTCallbacks = None) -> torch.Tensor:
    """Type-2 NUFFT over chunks: ``uhat`` of shape ``plan.spectral_shape``
    (optionally with a leading C axis); the output as :func:`exec_type2`'s."""
    _check_set(cplan)
    callbacks = callbacks or NUFFTCallbacks()
    p0 = whole_plan(cplan)
    uhat, had_axis = ex.prepare_type2(p0, uhat)
    if p0.spread_method == "direct":
        uhat = apply_uniform_callback(uhat, callbacks.uniform)
        vp = torch.cat([exec_type2_direct(p, uhat) for p in cplan.plans], dim=1)
    else:
        vp = ex.type2_groups(p0, uhat, callbacks.uniform, lambda _, grid: torch.cat(
            [ex.t2_interp_stage(p, grid) for p in cplan.plans], dim=1))
    vp = apply_nonuniform_callback(vp, callbacks.nonuniform)
    return vp if had_axis else vp[0]
