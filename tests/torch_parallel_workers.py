"""Rank processes of ``tests/test_torch_parallel.py``: gloo ranks on the CPU
that drive the port's two multi-device modes and save what they compute.

This module imports numpy, torch and the port only (no JAX): each spawned
rank imports it.  Every case makes its global inputs from a numpy seed with
:func:`case_inputs`, which the test process calls too to compute JAX's
results, and takes its own slice of the points.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: The spatial-mode cases: ``spatial`` holds the keyword arguments of
#: ``SpatialNUFFT``, ``np_rank`` the points of each rank, ``C`` the
#: transforms.  ``engine='auto'`` picks block form for all of them but
#: ``c128_sharded`` and ``f64_sharded_split`` (the split engine, dim-1
#: shards); a real 2D plan's
#: halved dim 1 (N1 / 2 + 1) and ``c128_30``'s dim 1 are padded around the
#: transposes.
CASES = {
    "c128_n4": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=64, spatial=dict(m=4, sigma=1.5)),
    "c128_sharded": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=64,
                         spatial=dict(m=4, sigma=1.5, spectrum="sharded", engine="split")),
    "c128_sharded_auto": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=64,
                              spatial=dict(m=4, sigma=1.5, spectrum="sharded")),
    "c128_30": dict(dtype=np.complex128, shape=(32, 30), np_rank=100, spatial=dict(m=4, sigma=1.5)),
    "f64_2d": dict(dtype=np.float64, shape=(24, 20), np_rank=100, spatial=dict(m=4, sigma=2.0)),
    "f64_2d_sharded": dict(dtype=np.float64, shape=(32, 32), np_rank=100,
                           spatial=dict(m=4, sigma=1.5, spectrum="sharded")),
    "ntransforms_sharded": dict(dtype=np.complex128, shape=(16, 14, 16), np_rank=48, C=2,
                                spatial=dict(m=4, sigma=1.5, ntransforms=2, spectrum="sharded")),
    "f64_r2c": dict(dtype=np.float64, shape=(16, 16, 16), np_rank=64, spatial=dict(m=4, sigma=1.5)),
    "c128_2d": dict(dtype=np.complex128, shape=(32, 32), np_rank=100, spatial=dict(m=4, sigma=2.0)),
    "skewed": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=64,
                   spatial=dict(m=4, sigma=1.5, capacity_factor=4.0)),
    "ntransforms": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=48, C=2,
                        spatial=dict(m=4, sigma=1.5, ntransforms=2)),
    "f64_sharded": dict(dtype=np.float64, shape=(16, 16, 12), np_rank=60,
                        spatial=dict(m=4, sigma=2.0, spectrum="sharded")),
    "f64_sharded_split": dict(dtype=np.float64, shape=(16, 16, 12), np_rank=60,
                              spatial=dict(m=4, sigma=2.0, spectrum="sharded", engine="split")),
    "c128_n2": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=80, spatial=dict(m=4, sigma=1.5)),
    "f64_r2c_n2": dict(dtype=np.float64, shape=(12, 16, 10), np_rank=80, spatial=dict(m=5, sigma=2.0)),
    "c128_n1_fftshift": dict(dtype=np.complex128, shape=(16, 12, 16), np_rank=200,
                             spatial=dict(m=4, sigma=1.5, fftshift=True)),
    # Groups of transforms: C = 3 run in one pass and with the slab plan's
    # transform_chunk forced to 2 (groups of 2 and 1).
    "c128_groups": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=48, C=3, groups=2,
                        spatial=dict(m=4, sigma=1.5, ntransforms=3)),
    "c128_groups_sharded": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=48, C=3,
                                groups=2,
                                spatial=dict(m=4, sigma=1.5, ntransforms=3, spectrum="sharded")),
    "c128_groups_split": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=48, C=3,
                              groups=2, spatial=dict(m=4, sigma=1.5, ntransforms=3,
                                                     spectrum="sharded", engine="split")),
    "f64_groups_n2": dict(dtype=np.float64, shape=(12, 16, 10), np_rank=80, C=3, groups=2,
                          spatial=dict(m=4, sigma=2.0, ntransforms=3)),
    # Every point in rank 0's slab (``skew``): the ranks receive different
    # numbers of points and, on a fabricated card, choose different group
    # sizes (``AGREE_CASES``).
    "c128_groups_skewed": dict(dtype=np.complex128, shape=(16, 16, 16), np_rank=48, C=3,
                               skew=True, spatial=dict(m=4, sigma=1.5, ntransforms=3,
                                                       capacity_factor=4.0)),
}
#: Construction-only cases of the engine choice: (dtype, shape, keyword
#: arguments of ``SpatialNUFFT``), all at m = 4, sigma = 1.5.
ENGINE_CASES = {
    "c64_auto": (np.complex64, (16, 16, 16), {}),
    "c128_auto": (np.complex128, (16, 16, 16), {}),
    "f64_auto_sharded": (np.float64, (16, 16, 16), dict(spectrum="sharded")),
    "c128_2d_30": (np.complex128, (32, 30), {}),
    "c128_variant_auto": (np.complex128, (16, 16, 16), dict(fft_variant="auto")),
    "c64_double": (np.complex64, (16, 16, 16), dict(precision="double")),
    "c128_variant_split": (np.complex128, (16, 16, 16), dict(fft_variant="split")),
    "c128_xla": (np.complex128, (16, 16, 16), dict(fft_method="xla")),
    "c128_split": (np.complex128, (16, 16, 16), dict(engine="split")),
    "c128_blockform": (np.complex128, (16, 16, 16), dict(engine="blockform")),
    "c64_blockform_double": (np.complex64, (16, 16, 16),
                             dict(engine="blockform", precision="double")),
    "c64_blockform_variant_split": (np.complex64, (16, 16, 16),
                                    dict(engine="blockform", fft_variant="split")),
}
#: The point-sharded cases (``exec_type{1,2}_sharded``).
SHARDED_CASES = {
    "pts_c128": dict(dtype=np.complex128, shape=(24, 18), np_rank=50),
    "pts_f64": dict(dtype=np.float64, shape=(24, 18), np_rank=50),
}
#: Point-sharded cases of C = 3 transforms, run in one pass and with the
#: plan's transform_chunk forced to 2.
GROUPED_SHARDED_CASES = {
    "pts_c128_groups": dict(dtype=np.complex128, shape=(24, 18), np_rank=50, C=3, groups=2),
    "pts_f64_groups_n2": dict(dtype=np.float64, shape=(20, 16, 12), np_rank=60, C=3, groups=2),
}
#: Point-sharded cases whose ranks hold different numbers of points
#: (:func:`_uneven_slice`).
UNEVEN_SHARDED_CASES = {
    "pts_c128_uneven": dict(dtype=np.complex128, shape=(24, 18), np_rank=50, C=3),
}
#: Cases run on a fabricated card on which the ranks choose different group
#: sizes (:func:`_fake_card`, :func:`_card_between`): one spatial, one
#: point-sharded.
AGREE_CASES = ("c128_groups_skewed", "pts_c128_uneven")
#: SpatialNUFFT configurations whose slab model the ``slab_model`` case
#: reports (dtype, shape, keyword arguments), at m = 4.
SLAB_MODEL_CASES = {
    "c128_replicated": (np.complex128, (32, 32, 32), dict(sigma=1.5, ntransforms=8)),
    "c64_sharded": (np.complex64, (32, 32, 32), dict(sigma=2.0, ntransforms=8,
                                                     spectrum="sharded")),
    "c128_split": (np.complex128, (32, 32, 32), dict(sigma=1.5, ntransforms=8,
                                                     spectrum="sharded", engine="split")),
    "f64_2d": (np.float64, (64, 48), dict(sigma=2.0, ntransforms=8)),
}


def case_inputs(name: str, n: int):
    """Global points (D, n Np_l) and channel values (C, [2,] n Np_l) of a case."""
    case = {**CASES, **SHARDED_CASES, **GROUPED_SHARDED_CASES, **UNEVEN_SHARDED_CASES}[name]
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    D, np_ = len(case["shape"]), n * case["np_rank"]
    pts = rng.uniform(0, 2 * np.pi, (D, np_))
    if name == "skewed" or case.get("skew"):
        pts[0] = rng.uniform(0, 0.3, np_)  # everything in rank 0's slab
    C = case.get("C", 1)
    real = np.dtype(case["dtype"]).kind == "f"
    v_ch = rng.standard_normal((C, np_) if real else (C, 2, np_))
    return pts, v_ch


def _rank_slice(x, rank, n):
    np_ = x.shape[-1] // n
    return x[..., rank * np_ : (rank + 1) * np_]


def _spatial_case(name, n, rank):
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT

    case = CASES[name]
    pts, v_ch = case_inputs(name, n)
    sp = SpatialNUFFT(case["dtype"], case["shape"], device="cpu", **case["spatial"])
    st = sp.set_points(_rank_slice(pts, rank, n))
    v_l = _rank_slice(v_ch, rank, n)
    u = sp.exec_type1(st, v_l)
    out = dict(u=u, v2=sp.exec_type2(st, u), bytes=sp.collective_bytes(),
               engine=sp.engine, shard_dim=sp.spectrum_shard_dim, k1_local=sp.k1_local,
               k0_local=sp.k0_local, transform_chunk=st.local.transform_chunk)
    if "groups" in case:
        # The same state with the slab plan's group size forced; type 2
        # takes the one-pass spectrum.
        grouped = dataclasses.replace(
            st, local=dataclasses.replace(st.local, transform_chunk=case["groups"]))
        out.update(u_grouped=sp.exec_type1(grouped, v_l), v2_grouped=sp.exec_type2(grouped, u))
    return out


def _engines():
    """``(engine, spectrum_shard_dim)`` of each construction-only case, or
    the message of the ValueError it raises."""
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT

    out = {}
    for key, (dtype, shape, kw) in ENGINE_CASES.items():
        try:
            sp = SpatialNUFFT(dtype, shape, device="cpu", m=4, sigma=1.5, **kw)
            out[key] = (sp.engine, sp.spectrum_shard_dim)
        except ValueError as e:
            out[key] = str(e)
    return out


def _sharded_case(name, n, rank):
    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.parallel import exec_type1_sharded, exec_type2_sharded, shard_points

    case = SHARDED_CASES[name]
    pts, v_ch = case_inputs(name, n)
    plan = nufft.PlanNUFFT(case["dtype"], case["shape"], sigma=2.0, device="cpu")
    pts_l, v_l = shard_points(torch.from_numpy(pts), torch.from_numpy(v_ch), device="cpu")
    u = exec_type1_sharded(plan, pts_l, v_l)
    return dict(u=u, v2=exec_type2_sharded(plan, pts_l, u))


def _grouped_sharded_case(name, n, rank):
    """The point-sharded mode on C transforms in one pass and with the
    plan's ``transform_chunk`` forced; type 2 takes the one-pass spectrum."""
    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch.parallel import exec_type1_sharded, exec_type2_sharded, shard_points

    case = GROUPED_SHARDED_CASES[name]
    pts, v_ch = case_inputs(name, n)
    plan = nufft.PlanNUFFT(case["dtype"], case["shape"], sigma=2.0, ntransforms=case["C"],
                           device="cpu")
    grouped = dataclasses.replace(plan, transform_chunk=case["groups"])
    pts_l, v_l = shard_points(torch.from_numpy(pts), torch.from_numpy(v_ch), device="cpu")
    u = exec_type1_sharded(plan, pts_l, v_l)
    return dict(u=u, v2=exec_type2_sharded(plan, pts_l, u),
                u_grouped=exec_type1_sharded(grouped, pts_l, v_l),
                v2_grouped=exec_type2_sharded(grouped, pts_l, u))


def _uneven_slice(np_: int, rank: int, n: int) -> slice:
    """Rank ``rank``'s points of ``np_`` split in proportion 1 : 2 : .. : n."""
    bounds = [np_ * k * (k + 1) // (n * (n + 1)) for k in range(n + 1)]
    return slice(bounds[rank], bounds[rank + 1])


def _fake_card(card_bytes: int, chosen: list):
    """``plan.with_transform_chunk`` on a fabricated card of ``card_bytes``,
    for CPU plans too: each rank plans with its share of the card, and each
    choice is appended to ``chosen``."""
    from nonuniformffts_tpu_torch import plan as tplan

    def choose(plan, *, ranks_on_device=1, **model_kw):
        chunk = tplan.choose_transform_chunk(device_bytes=card_bytes // ranks_on_device,
                                             **{**tplan.model_arguments(plan), **model_kw})
        chosen.append(chunk)
        return dataclasses.replace(plan, transform_chunk=chunk)

    return choose


def _card_between(ws, n: int) -> int:
    """A card shared by the n ranks on which the rank whose modelled working
    set ``ws`` at two transforms a group is the largest chooses one, and the
    rank whose is the smallest chooses two: its share budgets the midpoint
    of the ranks' totals (one all_gather)."""
    from nonuniformffts_tpu_torch.plan import TRANSFORM_MEMORY_FRACTION

    totals = [None] * n
    dist.all_gather_object(totals, ws.total(2))
    budget = (min(totals) + max(totals)) // 2
    return n * math.ceil(budget / TRANSFORM_MEMORY_FRACTION)


def _agree_spatial_case(name, n, rank):
    """A spatial case in one pass, then set again on a fabricated card on
    which the ranks choose different group sizes: each rank's own choice,
    the one it runs, and its results."""
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT, spatial

    case = CASES[name]
    pts, v_ch = case_inputs(name, n)
    sp = SpatialNUFFT(case["dtype"], case["shape"], device="cpu", **case["spatial"])
    pts_l, v_l = _rank_slice(pts, rank, n), _rank_slice(v_ch, rank, n)
    st = sp.set_points(pts_l)
    u = sp.exec_type1(st, v_l)
    chosen, real = [], spatial.with_transform_chunk
    spatial.with_transform_chunk = _fake_card(_card_between(sp.working_set(st), n), chosen)
    try:
        grouped = sp.set_points(pts_l)
    finally:
        spatial.with_transform_chunk = real
    return dict(u=u, v2=sp.exec_type2(st, u), own=chosen[0],
                agreed=grouped.local.transform_chunk, received=int(st.recv_idx.numel()),
                u_grouped=sp.exec_type1(grouped, v_l), v2_grouped=sp.exec_type2(grouped, u))


def _agree_sharded_case(name, n, rank):
    """A point-sharded case with uneven point counts in one pass, then on a
    fabricated card on which the ranks choose different group sizes: each
    rank's own choice, type 1's (agreed) and type 2's, and its results."""
    import nonuniformffts_tpu_torch as nufft
    from nonuniformffts_tpu_torch import plan as tplan
    from nonuniformffts_tpu_torch.parallel import exec_type1_sharded, exec_type2_sharded, sharded

    case = UNEVEN_SHARDED_CASES[name]
    pts, v_ch = case_inputs(name, n)
    sl = _uneven_slice(pts.shape[-1], rank, n)
    pts_l, v_l = torch.from_numpy(pts[..., sl]), torch.from_numpy(v_ch[..., sl])
    plan = nufft.PlanNUFFT(case["dtype"], case["shape"], sigma=2.0, ntransforms=case["C"],
                           device="cpu")
    u = exec_type1_sharded(plan, pts_l, v_l)
    ws = tplan.transform_working_set(**tplan.model_arguments(nufft.set_points(plan, pts_l)))
    chosen, real = [], sharded.with_transform_chunk
    sharded.with_transform_chunk = _fake_card(_card_between(ws, n), chosen)
    try:
        agreed = sharded.local_plan(plan, pts_l, agree=True).transform_chunk
        type2 = sharded.local_plan(plan, pts_l).transform_chunk
        u_grouped = exec_type1_sharded(plan, pts_l, v_l)
        v2_grouped = exec_type2_sharded(plan, pts_l, u)
    finally:
        sharded.with_transform_chunk = real
    return dict(u=u, v2=exec_type2_sharded(plan, pts_l, u), own=chosen[0], agreed=agreed,
                type2_chunk=type2, bounds=(sl.start, sl.stop), u_grouped=u_grouped,
                v2_grouped=v2_grouped)


def _sharing(n, rank):
    """The device census: every rank of the group on the host's CPU, as
    ``comm.ranks_on_device`` and ``SpatialNUFFT.set_points`` count it."""
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT, comm

    sp = SpatialNUFFT(np.complex128, (16, 16), device="cpu", m=4, sigma=1.5)
    st = sp.set_points(np.random.default_rng(rank).uniform(0, 2 * np.pi, (2, 20)))
    return dict(ranks_on_device=comm.ranks_on_device(torch.device("cpu")),
                spatial=st.ranks_on_device)


def _slab_models(n, rank):
    """Each ``SLAB_MODEL_CASES`` configuration's arguments of the memory
    model (``plan.model_arguments`` of the slab plan, replaced by
    ``SpatialNUFFT.slab_model``'s), the extended slab and the rank's
    output shape, on 200 uniform points a rank."""
    from nonuniformffts_tpu_torch import plan as tplan
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT

    out = {}
    rng = np.random.default_rng(7 + rank)
    for key, (dtype, shape, kw) in SLAB_MODEL_CASES.items():
        sp = SpatialNUFFT(dtype, shape, device="cpu", m=4, **kw)
        st = sp.set_points(rng.uniform(0, 2 * np.pi, (len(shape), 200)))
        model = {**tplan.model_arguments(st.local), **sp.slab_model(st.local, 200)}
        out[key] = dict(model=model, ext_shape_over=sp.ext_shape_over,
                        output_shape=sp.output_shape, n0_local=sp.n0_local,
                        k1_local=sp.k1_local, global_shape_over=sp.base.shape_over,
                        global_spectral_shape_over=sp.base.spectral_shape_over,
                        global_spectral_shape=sp.base.spectral_shape)
    return out


def _errors(n, rank):
    """The message of each validation error, per rank."""
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT

    out = {}

    def catch(key, fn):
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)

    kw = dict(device="cpu", m=4, sigma=1.5)
    if n == 2:
        # 50 grid planes split in two, but the 33 modes of spectral dim 0
        # do not (the JAX package's test_spatial.py:302).
        catch("dim0", lambda: SpatialNUFFT(np.complex128, (33, 32, 32), spectrum="sharded",
                                           **kw))
        return out
    catch("ndim", lambda: SpatialNUFFT(np.complex128, (64,), **kw))
    catch("spectrum", lambda: SpatialNUFFT(np.complex128, (32, 32), spectrum="cols", **kw))
    catch("engine", lambda: SpatialNUFFT(np.complex128, (32, 32), engine="fast", **kw))
    catch("variant", lambda: SpatialNUFFT(np.complex128, (32, 32), engine="split",
                                          fft_variant="pruned", **kw))
    catch("slab", lambda: SpatialNUFFT(np.complex128, (8, 8, 8), device="cpu", m=6, sigma=2.0))
    catch("dim1", lambda: SpatialNUFFT(np.complex128, (32, 30), engine="split", **kw))
    catch("indivisible", lambda: SpatialNUFFT(np.float64, (32, 32), spectrum="sharded",
                                              engine="split", **kw))
    sp = SpatialNUFFT(np.complex128, (32, 32), **kw)
    rng = np.random.default_rng(3)
    catch("npoints", lambda: sp.set_points(rng.uniform(0, 6, (2, 100 + (rank == 0)))))
    over = SpatialNUFFT(np.complex128, (16, 16, 16), capacity_factor=0.5, **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, 64))
    pts[0] = 0.1  # every rank routes everything to rank 0
    catch("overflow", lambda: over.set_points(pts))
    out["ok_after"] = float(sp.exec_type1(sp.set_points(rng.uniform(0, 6, (2, 100))),
                                          rng.standard_normal((1, 2, 100))).abs().sum())
    return out


def worker(rank, n, rdv, out_dir, names):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=60))
    for name in names:
        try:
            if name == "errors":
                res = _errors(n, rank)
            elif name == "engines":
                res = _engines()
            elif name == "sharing":
                res = _sharing(n, rank)
            elif name == "slab_model":
                res = _slab_models(n, rank)
            elif name in UNEVEN_SHARDED_CASES:
                res = _agree_sharded_case(name, n, rank)
            elif name in AGREE_CASES:
                res = _agree_spatial_case(name, n, rank)
            elif name in GROUPED_SHARDED_CASES:
                res = _grouped_sharded_case(name, n, rank)
            elif name in SHARDED_CASES:
                res = _sharded_case(name, n, rank)
            else:
                res = _spatial_case(name, n, rank)
        except Exception:  # recorded for the test of this case
            res = dict(failed=traceback.format_exc())
            print(f"rank {rank}, case {name}:\n{res['failed']}", file=sys.stderr, flush=True)
        torch.save(res, os.path.join(out_dir, f"{name}.{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(n: int, names, out_dir: str, timeout: float = 240.0):
    """Spawn ``n`` gloo ranks that run ``names``; returns ``{name: [result of
    rank 0, ..]}``.  A rank still running after ``timeout`` seconds is
    killed and the call raises ``TimeoutError``."""
    ctx = mp.start_processes(worker, args=(n, os.path.join(out_dir, "rendezvous"), out_dir,
                                           list(names)),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n} ranks still running after {timeout} s")
    return {name: [torch.load(os.path.join(out_dir, f"{name}.{r}.pt"), weights_only=False)
                   for r in range(n)] for name in names}
