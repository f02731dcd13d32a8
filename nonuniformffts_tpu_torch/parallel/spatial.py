"""Spatially sharded multi-device NUFFT: the oversampled grid split over the
ranks of a ``torch.distributed`` group.

Counterpart of ``nonuniformffts_tpu/parallel/spatial.py``.  The JAX package
has two engines there, and ``engine`` chooses between them as it does
(:func:`jax_engine`): block form (``'blockform'``, what ``'auto'`` picks
for every z-form plan) and split.  The port computes both engines' results
and spectrum layouts with one algorithm, the split engine's slab
transposes (the JAX package's ``:763-818`` and ``:879-945``) on cuFFT; the
block-form engine's MXU factor-matrix DFT, with the halo fold in its
factors, is a TPU device and has no counterpart.  Per-rank memory is
O(grid / n):

- rank ``r`` of ``n`` owns the grid planes ``[r N0l, (r + 1) N0l)`` along
  dim 0 (``N0l = N0 / n``) and, after the transposes, the spectral columns
  ``[r K1l, (r + 1) K1l)`` along dim 1, where ``K1l = ceil(K1 / n)``:
  spectral dim 1 is padded with zero modes to ``K1p = n K1l`` around the
  transposes and cropped after, so that any K1 splits;
- ``set_points`` routes each point's (cell, fraction) to its owner rank with
  one capacity-bounded all_to_all (overflow is detected on every rank and
  raised, never dropped) and bin-sorts the received points for a local plan
  over the rank's *extended slab*, the planes ``[r N0l - (M - 1), (r + 1)
  N0l + M)`` padded up to a multiple of 8: every window node of a point the
  rank owns lies inside it, so the spread and interpolation kernels (K1/K2,
  K4/K5 in 2D) never wrap in dim 0 and need no change;
- type 1: route the values, spread into the extended slab, add the M - 1
  leading and M trailing halo planes into the neighbours' slabs (a
  point-to-point exchange with the two neighbours), FFT and truncate dims
  1.., pad dim 1 to K1p, pack rank-major (K8b), all_to_all, FFT and
  truncate dim 0, deconvolve (the dim-1 factor padded and sliced); for
  ``spectrum='replicated'`` all_gather the dim-1 shards and unpack them
  (K8a); for ``spectrum='sharded'`` the split engine returns the dim-1
  shard, and block form turns it into the dim-0 shard ``[r K0l, (r + 1)
  K0l)`` (``K0l = K0 / n``) with one more all_to_all and an unpack (K8a);
- type 2 mirrors it: take the dim-1 shard (sliced from a replicated
  spectrum; from a block-form dim-0 shard by a pack, K8b, and an
  all_to_all) and deconvolve, pad and inverse-FFT dim 0, all_to_all, unpack
  (K8a), crop dim 1 to K1, pad and inverse-FFT dims 1.., gather the halo
  planes from the neighbours, interpolate, and route the values back to the
  caller's order.

``engine`` and ``spectrum_shard_dim`` report what the JAX package reports
(``'blockform'`` and 0, or ``'split'`` and 1), and the split engine
refuses what the JAX package's refuses (dim 1 of the grid not divisible by
n).

Each process passes its own points and values (``(D, Np_l)``, the same
``Np_l`` on every rank) and gets its own values back; spectra are in the
channel form, ``(C, 2) + spectral_shape`` replicated, or this rank's shard
``(C, 2, K0l, K1, ..)`` (block form) / ``(C, 2, K0, K1l, ..)`` (split).
With ``ntransforms > 1`` the transposes run one channel at a time (K8's
layout keeps the channel axis leading, which is rank-major only for one
channel); the all_gather folds the channels into dim 0 and stays one call
a group.

Many transforms run in groups (the slab plan's ``transform_chunk``, the
plain plans' and the JAX package's ``cr_chunk``): routing the values stays
one call for all C, and each group runs the whole chain above, spread to
spectrum or spectrum to values, into an output allocated once.
``set_points`` chooses the group size on the card from the slab's model
(:meth:`SpatialNUFFT.slab_model`, ``plan.py:transform_working_set``) and
this rank's share of its card: the ranks of the group that run on one
card each plan with ``1 / k`` of its memory, ``k`` counted from the same
all_gather that checks the point counts.  The ranks then take the
smallest of their choices (``comm.agreed_chunk``, one all_reduce), so that
every rank runs the same collectives a group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.distributed as dist

from .. import execution as ex
from ..blocking import bin_sort, cells_and_fracs, choose_geometry
from ..ops.deconvolve import pad_axis, truncate_axis
from ..ops.kernels.blocked import (check_kernel_support, interpolate_blocked, spread_blocked,
                                   window_taps)
from ..ops.kernels.common import VALUE_TYPES
from ..ops.kernels.relayout import relayout_to_blocks, relayout_to_grid
from ..plan import (Plan, PlanNUFFT, WorkingSet, _as_real_tensor, _canonicalise_points,
                    _identity, model_arguments, point_state_bytes, transform_groups,
                    transform_working_set, with_transform_chunk)
from . import comm

#: The extended slab's planes are padded up to a multiple of this, so that
#: the geometry chooser finds block dims that divide them.
SLAB_ALIGN = 8


@dataclasses.dataclass(frozen=True, eq=False)
class SpatialPoints:
    """One rank's routed point state."""

    send_idx: torch.Tensor  # (n * cap,) local point index of each send slot
    send_pos: torch.Tensor  # (Np_l,) send slot of each local point
    recv_idx: torch.Tensor  # (Nv,) receive slots that hold a point
    # extended-slab plan over the Nv received points; its transform_chunk is
    # the exec's group size
    local: Plan
    cap: int  # points per (src, dst) lane
    num_points: int  # Np over all ranks
    ranks_on_device: int = 1  # ranks of the group on this rank's device


def jax_engine(engine: str, ndim: int, shape_over, plan_kw) -> str:
    """The engine the JAX package's ``SpatialNUFFT`` runs for these
    arguments: ``'blockform'`` for a z-form plan (blocked spread, matmul FFT
    with the pruned variant, D >= 2, precision != 'double'; its
    ``parallel/spatial.py:136-160`` and ``plan.py:560-590``; ``'auto'`` sets
    the pruned variant and the matmul FFT unless they are given), else
    ``'split'``.  ``engine='blockform'`` on any other plan raises the JAX
    package's error."""
    if engine == "split":
        return "split"
    variant = plan_kw.get("fft_variant", "pruned")
    if variant == "auto":
        variant = "pruned" if max(shape_over) <= 1024 else "split"
    if (plan_kw.get("spread_method", "blocked") == "blocked"
            and plan_kw.get("fft_method", "matmul") in ("matmul", None)  # None: matmul on a TPU
            and variant == "pruned" and ndim >= 2
            and plan_kw.get("precision", "highest") != "double"):
        return "blockform"
    if engine == "blockform":
        raise ValueError(
            "engine='blockform' needs the z-form kernels (blocked spread, matmul FFT "
            "with the pruned variant, D >= 2, precision != 'double'); got "
            "kernel_form='yz'"
        )
    return "split"


class SpatialNUFFT:
    """Grid-sharded NUFFT over a ``torch.distributed`` group (default: the
    default group), one process per rank.

    Parameters mirror :func:`PlanNUFFT` (``device`` included: the card by
    default); additionally ``capacity_factor`` (routing slack: each (src
    rank -> dst rank) lane holds up to ``capacity_factor * Np_l / n``
    points; heavier skew raises a ValueError at set_points on every rank),
    ``engine`` (``'auto'``, ``'blockform'`` or ``'split'``, chosen and
    checked as the JAX package does; both run the port's slab transposes)
    and ``spectrum`` (``'replicated'`` or ``'sharded'`` along
    ``spectrum_shard_dim``).
    """

    def __init__(self, dtype, shape, *, group=None, capacity_factor: float = 4.0,
                 engine: str = "auto", spectrum: str = "replicated", **plan_kw):
        if spectrum not in ("replicated", "sharded"):
            raise ValueError(f"unknown spectrum layout {spectrum!r}")
        if engine not in ("auto", "blockform", "split"):
            raise ValueError(f"unknown SpatialNUFFT engine {engine!r}")
        if engine == "split" and plan_kw.get("fft_variant", "split") != "split":
            raise ValueError(
                "SpatialNUFFT engine='split' requires fft_variant='split': the "
                "distributed DFT interleaves truncation/padding with the "
                f"collective transposes (got fft_variant={plan_kw['fft_variant']!r})"
            )
        self.group = group
        self.n = n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.capacity_factor = float(capacity_factor)
        self.spectrum = spectrum
        plan_kw.setdefault("spread_method", "blocked")
        base = PlanNUFFT(dtype, shape, **plan_kw)
        self.engine = jax_engine(engine, base.ndim, base.shape_over, plan_kw)
        if base.ndim < 2:
            raise ValueError("spatial sharding needs >= 2 dimensions")
        n0, m = base.shape_over[0], base.m
        if n0 % n or n0 // n < m:
            # Each slab must be at least M planes thick: a window's halo
            # then reaches only the neighbouring slabs.
            raise ValueError(
                f"cannot split {n0} grid planes into block rows divisible by {n} chips"
            )
        k1 = base.spectral_shape[1]
        # The JAX package's split engine shards dim 1 evenly; block form
        # never shards it (the port pads it around its transposes).
        if self.engine == "split" and (base.shape_over[1] % n or base.shape[1] % n):
            raise ValueError(
                f"dim-1 sizes ({base.shape[1]}, oversampled "
                f"{base.shape_over[1]}) must divide by the mesh size {n}"
            )
        if spectrum == "sharded":
            d = self.spectrum_shard_dim
            if base.spectral_shape[d] % n:
                raise ValueError(
                    f"spectrum='sharded' needs spectral dim {d} "
                    f"({base.spectral_shape[d]}) divisible by the mesh size {n}"
                )
        if self.engine == "split" and k1 % n:
            raise ValueError(
                f"the split engine's transposes need spectral dim 1 ({k1}) divisible "
                f"by the mesh size {n}"
            )
        self.base = base
        self.n0_local = n0 // n
        self.k1_local = -(-k1 // n)
        self.k0_local = base.spectral_shape[0] // n
        # Dim 1's deconvolution factors on this rank's columns, the padding
        # (zero modes) included.
        ph1 = _pad_to(base.phihat_inv[1], 0, n * self.k1_local)
        self._phihat1 = ph1[self.rank * self.k1_local:(self.rank + 1) * self.k1_local]
        planes = self.n0_local + 2 * m - 1
        self.ext_shape_over = (-(-planes // SLAB_ALIGN) * SLAB_ALIGN,) + base.shape_over[1:]
        _, scalar_bytes, ncomp = VALUE_TYPES[base.dtype]
        kd0 = dataclasses.replace(base.kernel_data[0], n=self.ext_shape_over[0])
        self._slab_plan = dataclasses.replace(
            base,
            shape_over=self.ext_shape_over,
            block_dims=choose_geometry(self.ext_shape_over, m, scalar_bytes, ncomp),
            kernel_data=(kd0,) + base.kernel_data[1:],
            spread_method="blocked",
            # The slab's own shape_over would inflate the FFT normalisation by
            # n: interpolation keeps the global grid's.
            normfactor_override=base.normfactor,
        )
        if base.device.type == "cuda":
            check_kernel_support(self._slab_plan)

    @property
    def spectrum_shard_dim(self) -> int:
        """The spectral dimension ``spectrum='sharded'`` splits, as in the
        JAX package: dim 0 for block form, dim 1 for the split engine (whose
        distributed DFT is dim-1-sharded after its transpose)."""
        return 0 if self.engine == "blockform" else 1

    def _capacity(self, np_local: int) -> int:
        cap = int(math.ceil(self.capacity_factor * np_local / self.n))
        return max(-(-cap // 8) * 8, 8)

    # -- set_points -----------------------------------------------------------
    def set_points(self, points) -> SpatialPoints:
        """Route this rank's points to their owner ranks and build the local
        slab plan.  ``points``: any format :func:`set_points` accepts, this
        rank's ``(D, Np_l)``, with the same ``Np_l`` on every rank."""
        base, n, me, group = self.base, self.n, self.rank, self.group
        D = base.ndim
        pts = _canonicalise_points(points, D, base.real_dtype, base.device)
        npl = int(pts.shape[1])
        # One all_gather of each rank's point count and device.
        key = comm.device_key(base.device)
        census = comm.all_gather(torch.cat([key.new_tensor([npl]), key]), group)
        counts_all = census[:, 0]
        np_total = int(counts_all.sum())
        if bool((counts_all != npl).any()):
            raise ValueError(
                f"number of points {np_total} must divide by mesh size {n}: every "
                f"rank passes the same number (got {counts_all.tolist()})"
            )
        cap = self._capacity(npl)
        if base.point_transform is not _identity:
            pts = base.point_transform(pts)
        cells, fracs = cells_and_fracs(base.kernel_data, pts)
        dest = torch.clamp(torch.div(cells[0], self.n0_local, rounding_mode="floor"),
                           0, n - 1).to(torch.int64)
        sdest, perm = torch.sort(dest, stable=True)
        counts = torch.bincount(dest, minlength=n)
        starts = torch.cumsum(counts, 0) - counts
        overflow = (counts > cap).any().to(torch.int64).reshape(1)
        if int(comm.all_reduce(overflow, group)) > 0:
            raise ValueError(
                "point routing overflow: a (src, dst) chip lane exceeded its "
                f"capacity ({cap} points). The point distribution is too "
                f"skewed for capacity_factor={self.capacity_factor}; increase it."
            )
        slot = torch.arange(n * cap, device=pts.device)
        d_of, r = slot // cap, slot % cap
        sidx = torch.clamp(starts[d_of] + r, 0, max(npl - 1, 0))
        send_idx = perm[sidx] if npl else torch.zeros_like(slot)
        send_pos = torch.empty(npl, dtype=torch.int64, device=pts.device)
        send_pos[perm] = sdest * cap + torch.arange(npl, device=pts.device) - starts[sdest]

        # One all_to_all each for the lane counts, cells and fractions.
        recv_counts = comm.all_to_all(counts.view(n, 1), group).view(n, 1)
        recv_idx = torch.nonzero(
            (torch.arange(cap, device=pts.device)[None, :] < recv_counts).reshape(-1)
        ).view(-1)
        cells_r = self._route(cells, send_idx, cap)[:, recv_idx]
        fracs_r = self._route(fracs, send_idx, cap)[:, recv_idx]
        # Global dim-0 cell -> extended-slab cell: its window starts at
        # plane c0 - (M - 1) >= r N0l - (M - 1), the slab's first plane.
        cells_r[0] -= me * self.n0_local - (base.m - 1)
        cells_s, fracs_s, perm_l, pstarts = bin_sort(
            cells_r.contiguous(), fracs_r.contiguous(), self.ext_shape_over,
            self._slab_plan.block_dims,
        )
        local = dataclasses.replace(
            self._slab_plan, cells_sorted=cells_s, fracs_sorted=fracs_s,
            sort_perm=perm_l, pstarts=pstarts, num_points_static=int(recv_idx.numel()),
        )
        local = dataclasses.replace(local, wtaps_sorted=window_taps(local))
        sharing = comm.ranks_sharing(census[:, 1:], key)
        st = SpatialPoints(send_idx=send_idx, send_pos=send_pos, recv_idx=recv_idx,
                           local=local, cap=cap, num_points=np_total, ranks_on_device=sharing)
        # Each group of transforms runs the chain's collectives: every rank
        # takes the smallest of the ranks' choices, which differ with the
        # points each receives and its share of a card.
        chunk = with_transform_chunk(local, ranks_on_device=sharing, **self.slab_model(
            local, npl, _tables_bytes(st))).transform_chunk
        chunk = comm.agreed_chunk(chunk, base.ntransforms, base.device, group)
        return dataclasses.replace(st, local=dataclasses.replace(local, transform_chunk=chunk))

    def working_set(self, state: SpatialPoints) -> WorkingSet:
        """The modelled device memory of this rank's execs on ``state``,
        from which ``set_points`` chose the group size."""
        model = self.slab_model(state.local, int(state.send_pos.numel()), _tables_bytes(state))
        return transform_working_set(**{**model_arguments(state.local), **model})

    def slab_model(self, local: Plan, np_local: int, tables_bytes: int = 0) -> dict:
        """The arguments of ``plan.py:transform_working_set`` for this rank's
        execs beside the slab plan ``local``'s own (its extended slab as the
        grid): the slab FFT'd over dims 1.. (what cuFFT writes), this rank's
        output a transform, and as the buffers a transform holds the
        truncation temporary (one FFT'd slab), the transposes' columns twice
        ((n n0l, k1l, ..), the padded slab and the transposed copy) and the
        gathered spectrum twice ((n, K0, k1l, ..) and its unpacked copy; a
        sharded spectrum's (K0, k1l, ..) shard): each counted as if all were
        held at once.  Fixed: the slab plan's point state, the routing
        tables (``tables_bytes``) and the routed values of all C."""
        base, n = self.base, self.n
        tail = tuple(base.spectral_shape[2:])
        fft_shape = (self.n0_local,) + tuple(base.spectral_shape_over[1:])
        cols = (n * self.n0_local, self.k1_local) + tail
        shard = (base.spectral_shape[0], self.k1_local) + tail
        gathered = (n,) + shard if self.spectrum == "replicated" else shard
        _, scalar_bytes, ncomp = VALUE_TYPES[base.dtype]
        routed = base.ntransforms * local.num_points * scalar_bytes * ncomp
        return dict(spectral_shape_over=fft_shape, spectral_shape=self.output_shape,
                    num_points=np_local,
                    point_state_bytes=point_state_bytes(local) + tables_bytes + routed,
                    slab_buffers=(fft_shape, cols, cols, gathered, gathered))

    @property
    def output_shape(self) -> Tuple[int, ...]:
        """A transform's spectrum on this rank: ``spectral_shape``, or its
        shard along ``spectrum_shard_dim``."""
        shape = list(self.base.spectral_shape)
        if self.spectrum == "sharded":
            shape[self.spectrum_shard_dim] //= self.n
        return tuple(shape)

    def _route(self, x: torch.Tensor, send_idx: torch.Tensor, cap: int) -> torch.Tensor:
        """(R, Np_l) rows in local order -> (R, n cap) rows at the owner ranks'
        receive slots (slot ``s cap + k``: the ``k``-th point from rank ``s``)."""
        R = x.shape[0]
        send = x[:, send_idx].reshape(R, self.n, cap).transpose(0, 1)
        return comm.all_to_all(send, self.group).transpose(0, 1).reshape(R, -1)

    def _unroute(self, vals: torch.Tensor, st: SpatialPoints) -> torch.Tensor:
        """(C, Nv) values of the received points -> (C, Np_l) at the source
        ranks, in their original order."""
        C = vals.shape[0]
        full = vals.new_zeros((C, self.n * st.cap))
        full[:, st.recv_idx] = vals
        back = comm.all_to_all(full.reshape(C, self.n, st.cap).transpose(0, 1), self.group)
        return back.transpose(0, 1).reshape(C, -1)[:, st.send_pos]

    # -- helpers of the distributed DFT --------------------------------------
    def _deconvolve(self, x: torch.Tensor) -> torch.Tensor:
        """Scale (C, K0, K1l, ..) by 1/phi_hat per dim, dim 1 sliced."""
        for d, ph in enumerate(self.base.phihat_inv):
            if d == 1:
                ph = self._phihat1
            shape = [1] * x.ndim
            shape[1 + d] = ph.shape[0]
            x = x * ph.reshape(shape)
        return x

    def _check_channels(self, x: torch.Tensor, tail: Tuple[int, ...], what: str):
        C = self.base.ntransforms
        lead = (C,) if self.base.is_real and what == "values" else (C, 2)
        if tuple(x.shape[: len(lead)]) != lead or tuple(x.shape[len(lead):]) != tail:
            raise ValueError(
                f"{what} of shape {tuple(x.shape)}; expected {lead + tail} "
                f"(ntransforms={C})"
            )

    # -- transforms -----------------------------------------------------------
    def exec_type1(self, state: SpatialPoints, v_ch) -> torch.Tensor:
        """Distributed type 1.  ``v_ch``: this rank's channel values, ``(C, 2,
        Np_l)`` (complex plans) or ``(C, Np_l)`` (real plans).  Returns the
        channel-form spectrum ``(C, 2) + spectral_shape`` (replicated) or, for
        ``spectrum='sharded'``, this rank's shard along ``spectrum_shard_dim``:
        ``(C, 2, K0l, K1, ..)`` (block form) or ``(C, 2, K0, K1l, ..)``."""
        base, C = self.base, self.base.ntransforms
        v_ch = _as_real_tensor(v_ch, base.real_dtype, base.device)
        self._check_channels(v_ch, (int(state.send_pos.numel()),), "values")
        v = v_ch if base.is_real else ex.from_channels(v_ch, 1)
        v = self._route(v, state.send_idx, state.cap)[:, state.recv_idx]
        out = torch.empty((C, 2) + self.output_shape, dtype=base.real_dtype, device=base.device)
        for sl in transform_groups(C, state.local.transform_chunk):
            out[sl] = torch.movedim(torch.view_as_real(self._type1_group(state, v[sl])), -1, 1)
        return out

    def _type1_group(self, state: SpatialPoints, v: torch.Tensor) -> torch.Tensor:
        """The routed values of a group of transforms, (C', Nv) -> this
        rank's complex spectra, (C',) + ``output_shape``."""
        base, n, group, m = self.base, self.n, self.group, self.base.m
        D, C = base.ndim, v.shape[0]
        # Spread into the extended slab; add the halo planes into the
        # neighbours' slabs.
        ext = spread_blocked(state.local, v)
        n0l = self.n0_local
        own = ext[:, m - 1 : m - 1 + n0l]
        from_next, from_prev = comm.neighbour_exchange(
            ext[:, : m - 1], ext[:, m - 1 + n0l : n0l + 2 * m - 1], group)
        if m > 1:
            own[:, n0l - (m - 1):] += from_next
        own[:, :m] += from_prev

        # FFT and truncate dims 1..; the dim-0 transpose; FFT and truncate
        # dim 0.
        dims = tuple(range(2, D + 1))
        x = torch.fft.rfftn(own, dim=dims) if base.is_real else torch.fft.fftn(own, dim=dims)
        del ext, own, from_next, from_prev
        for d in range(1, D):
            x = truncate_axis(x, 1 + d, base.index_ranges[d])
        x = _pad_to(x, 2, n * self.k1_local)
        k1l, tail = self.k1_local, tuple(base.spectral_shape[2:])
        cols = torch.empty((C, n * n0l, k1l) + tail, dtype=x.dtype, device=x.device)
        for c in range(C):
            packed = relayout_to_blocks(x[c : c + 1], (n0l, k1l) + tail)
            cols[c] = comm.all_to_all(packed.reshape((n, n0l, k1l) + tail), group).reshape(
                (n * n0l, k1l) + tail)
        del x, packed
        y = truncate_axis(torch.fft.fft(cols, dim=1), 1, base.index_ranges[0])
        del cols
        y = self._deconvolve(y * base.normfactor)
        K0, K1 = base.spectral_shape[:2]
        if self.spectrum == "sharded" and self.engine == "split":
            return y
        if self.spectrum == "sharded":
            # Dim-1 shards -> dim-0 shards: rows [s K0l, (s + 1) K0l) go to
            # rank s; what arrives is block-major with blocks (K0l, K1l, ..)
            # along dim 1.
            k0l = self.k0_local
            rows = torch.empty((C, k0l, K1) + tail, dtype=y.dtype, device=y.device)
            for c in range(C):
                recv = comm.all_to_all(y[c].reshape((n, k0l, k1l) + tail), group)
                rows[c] = relayout_to_grid(
                    recv.reshape((1, 1, n) + (1,) * (D - 2) + (k0l, k1l) + tail),
                    (k0l, k1l) + tail,
                )[0, :, :K1]
            return rows

        # Gather the dim-1 shards: (n, C, K0, K1l, ..) is block-major with
        # blocks (C K0, K1l, ..) along dim 1.
        gathered = comm.all_gather(y, group)
        del y
        return relayout_to_grid(
            gathered.reshape((1, 1, n) + (1,) * (D - 2) + (C * K0, k1l) + tail),
            (C * K0, k1l) + tail,
        ).reshape((C, K0, n * k1l) + tail)[:, :, :K1]

    def exec_type2(self, state: SpatialPoints, uhat_ch) -> torch.Tensor:
        """Distributed type 2.  ``uhat_ch``: the channel-form spectrum in the
        plan's layout (replicated, or this rank's shard as
        :meth:`exec_type1` returns it).  Returns this
        rank's ``(C, 2, Np_l)`` / ``(C, Np_l)`` channel values in its original
        point order."""
        base, C = self.base, self.base.ntransforms
        uhat_ch = _as_real_tensor(uhat_ch, base.real_dtype, base.device)
        self._check_channels(uhat_ch, self.output_shape, "spectrum")
        u = ex.from_channels(uhat_ch, 1)
        vals = torch.empty((C, state.local.num_points), dtype=base.dtype, device=base.device)
        for sl in transform_groups(C, state.local.transform_chunk):
            vals[sl] = self._type2_group(state, u[sl])
        back = self._unroute(vals, state)
        return back if base.is_real else ex.to_channels(back, 1)

    def _type2_group(self, state: SpatialPoints, u: torch.Tensor) -> torch.Tensor:
        """A group of transforms' spectra, (C',) + ``output_shape`` -> the
        values at the received points, (C', Nv)."""
        base, n, group, m, me = self.base, self.n, self.group, self.base.m, self.rank
        D, C = base.ndim, u.shape[0]
        n0l, k1l, tail = self.n0_local, self.k1_local, tuple(base.spectral_shape[2:])
        K1 = base.spectral_shape[1]
        if self.spectrum == "replicated":
            u = _pad_to(u[:, :, me * k1l : (me + 1) * k1l], 2, k1l)
        elif self.engine == "blockform":
            # Dim-0 shard -> dim-1 shard: pack dim 1 rank-major (K8b), and
            # rank s's block goes to rank s.
            k0l = self.k0_local
            cols = torch.empty((C, n * k0l, k1l) + tail, dtype=u.dtype, device=u.device)
            for c in range(C):
                packed = relayout_to_blocks(_pad_to(u[c : c + 1], 2, n * k1l), (k0l, k1l) + tail)
                cols[c] = comm.all_to_all(packed.reshape((n, k0l, k1l) + tail), group).reshape(
                    (n * k0l, k1l) + tail)
            u = cols
        u = self._deconvolve(u)
        z = torch.fft.ifft(pad_axis(u, 1, base.index_ranges[0], base.shape_over[0]),
                           dim=1, norm="forward")
        del u
        rows = torch.empty((C, n0l, n * k1l) + tail, dtype=z.dtype, device=z.device)
        for c in range(C):
            recv = comm.all_to_all(z[c].reshape((n, n0l, k1l) + tail), group)
            rows[c] = relayout_to_grid(
                recv.reshape((1, 1, n) + (1,) * (D - 2) + (n0l, k1l) + tail),
                (n0l, k1l) + tail,
            )[0]
        del z, recv
        x = rows[:, :, :K1]
        for d in range(1, D):
            x = pad_axis(x, 1 + d, base.index_ranges[d], base.spectral_shape_over[d])
        del rows
        dims = tuple(range(2, D + 1))
        if base.is_real:
            slab = torch.fft.irfftn(x, s=base.shape_over[1:], dim=dims, norm="forward")
        else:
            slab = torch.fft.ifftn(x, dim=dims, norm="forward")
        del x

        # The extended slab: the neighbours' halo planes around our own.
        ext = slab.new_zeros((C,) + self.ext_shape_over)
        ext[:, m - 1 : m - 1 + n0l] = slab
        from_next, from_prev = comm.neighbour_exchange(
            slab[:, :m], slab[:, n0l - (m - 1):] if m > 1 else slab[:, :0], group)
        del slab
        ext[:, m - 1 + n0l : n0l + 2 * m - 1] = from_next
        ext[:, : m - 1] = from_prev
        return interpolate_blocked(state.local, ext)

    def collective_bytes(self) -> dict:
        """Bytes this rank sends in each collective of one transform, as the
        port runs them (both engines): each all_to_all keeps one of its n
        blocks, the all_gather sends this rank's dim-1 shard to the n - 1
        others, and block form's sharded spectrum adds one all_to_all a
        transform (``t1_unshard_all_to_all``, ``t2_shard_all_to_all``).
        The JAX package's block-form formula counts a psum the port does
        not run; only ``engine`` and ``spectrum_shard_dim`` follow it."""
        base, n = self.base, self.n
        csize = torch.empty((), dtype=base.complex_dtype).element_size()
        col = base.ntransforms * self.k1_local * math.prod(base.spectral_shape[2:]) * csize
        transpose = (n - 1) * self.n0_local * col
        out = {"engine": self.engine, "spectrum": self.spectrum, "n": n,
               "t1_transpose_all_to_all": transpose, "t2_transpose_all_to_all": transpose,
               "t1_spectrum_all_gather": 0}
        K0 = base.spectral_shape[0]
        if self.spectrum == "replicated":
            out["t1_spectrum_all_gather"] = (n - 1) * K0 * col
        elif self.engine == "blockform":
            out["t1_unshard_all_to_all"] = out["t2_shard_all_to_all"] = (
                (n - 1) * self.k0_local * col)
        return out


def _tables_bytes(state: SpatialPoints) -> int:
    """Device bytes of a rank's routing tables."""
    return sum(t.numel() * t.element_size()
               for t in (state.send_idx, state.send_pos, state.recv_idx))


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to ``size``."""
    extra = size - x.shape[dim]
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim)
