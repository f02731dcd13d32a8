"""Point-sharded multi-device NUFFT over a ``torch.distributed`` group.

Counterpart of ``nonuniformffts_tpu/parallel/sharded.py`` (the JAX
package's ``shard_map`` over a device mesh), run by one process per rank:

- the non-uniform points and their values are split over the ranks (the
  NUFFT's batch axis);
- type 1: each rank runs its plan's spread of its own points into a full
  local oversampled grid, one all-reduce sums the grids, and every rank
  runs the FFT and ``deconvolve_truncate``: the spectrum comes out
  replicated;
- type 2: every rank pads, deconvolves and inverse-transforms the
  replicated spectrum and interpolates at its own points: no communication
  (but the device census of the group's first exec, below).

The spread and interpolation are the plan's: on the card with
``spread_method='blocked'`` the CUDA kernels.  ``make_mesh`` has no
counterpart: the group (default: the default process group) is the mesh.
Values and spectra are in the channel form (``execution.exec_type*_channels``).

Many transforms run in groups (``Plan.transform_chunk``) through
``execution.py``'s group loops, per group: spread, all-reduce, FFT,
deconvolve (type 1); pad, FFT, interpolate (type 2).  The group size is
the plan's own when the caller set one, else chosen on the card from this
rank's share of it: the group's ranks that run on the same card each plan
with ``1 / k`` of its memory (``comm.ranks_on_device``, counted once a
group).  Type 1's ranks then take the smallest of their choices
(``comm.agreed_chunk``), so that every rank runs the same all-reduces;
type 2's groups run no collective, and each rank keeps its own.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import execution as ex
from ..plan import Plan, _as_real_tensor, resolve_device, set_points, with_transform_chunk
from . import comm


def shard_points(points, vp=None, *, group=None, device=None):
    """This rank's slice of ``(D, Np)`` points (and of values sharded along
    their last axis), placed on ``device`` (default: the card).  ``Np`` must
    divide by the group's size."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dev = resolve_device(device)
    pts = points if isinstance(points, torch.Tensor) else torch.as_tensor(points)
    np_ = pts.shape[-1]
    if np_ % n:
        raise ValueError(f"number of points {np_} must divide by the group size {n}")
    sl = slice(me * (np_ // n), (me + 1) * (np_ // n))
    pts_l = pts[..., sl].to(dev)
    if vp is None:
        return pts_l
    v = vp if isinstance(vp, torch.Tensor) else torch.as_tensor(vp)
    return pts_l, v[..., sl].to(dev)


def local_plan(plan: Plan, points_local, group=None, *, agree: bool = False) -> Plan:
    """The plan each exec runs on this rank: ``plan`` with this rank's
    points set, its ``transform_chunk`` the plan's own when set, else chosen
    on the card from this rank's share of it (``comm.ranks_on_device``) and,
    with ``agree``, the smallest of the group's ranks' choices
    (``comm.agreed_chunk``, one all_reduce)."""
    local = set_points(plan, points_local)
    if plan.transform_chunk is not None:
        return dataclasses.replace(local, transform_chunk=plan.transform_chunk)
    local = with_transform_chunk(local, ranks_on_device=comm.ranks_on_device(plan.device, group))
    if not agree:
        return local
    return dataclasses.replace(local, transform_chunk=comm.agreed_chunk(
        local.transform_chunk, plan.ntransforms, plan.device, group))


def exec_type1_sharded(plan: Plan, points_local, vp_ch_local, *, group=None) -> torch.Tensor:
    """Distributed type 1.  ``points_local``: this rank's ``(D, Np_l)``
    points; ``vp_ch_local``: its channel-form values, ``(C, 2, Np_l)``
    (complex plans) or ``(C, Np_l)`` (real plans).  Returns the channel-form
    spectrum ``(C, 2) + spectral_shape``, the same on every rank."""
    local = local_plan(plan, points_local, group, agree=True)
    v = _as_real_tensor(vp_ch_local, plan.real_dtype, plan.device)
    if not plan.is_real:
        v = ex.from_channels(v, 1)
    if v.ndim != 2 or v.shape[0] != plan.ntransforms:
        raise ValueError(f"values of shape {tuple(vp_ch_local.shape)} for a plan of "
                         f"ntransforms={plan.ntransforms}")
    uhat = ex.type1_groups(local, v, spread=lambda p, vg: comm.all_reduce(
        ex.t1_spread_stage(p, vg).contiguous(), group))
    return ex.to_channels(uhat, 1)


def exec_type2_sharded(plan: Plan, points_local, uhat_ch, *, group=None) -> torch.Tensor:
    """Distributed type 2.  ``uhat_ch``: the replicated channel-form spectrum
    ``(C, 2) + spectral_shape``.  Returns this rank's channel-form values,
    ``(C, 2, Np_l)`` or ``(C, Np_l)``; no communication but the group's
    device census on its first exec (``comm.ranks_on_device``)."""
    local = local_plan(plan, points_local, group)
    u = ex.from_channels(_as_real_tensor(uhat_ch, plan.real_dtype, plan.device), 1)
    vals = ex.type2_groups(local, u)
    return vals if plan.is_real else ex.to_channels(vals, 1)
