"""The port's two multi-device modes (``nonuniformffts_tpu_torch.parallel``)
on gloo ranks on the CPU, against the JAX package's.

Mirrors ``tests/test_spatial.py`` and ``tests/test_sharding.py``.  The rank
processes (``torch_parallel_workers.py``, spawned; they import torch and the
port only) run every case in one spawn per group size, n = 4, 2 and 1, and
save what they compute; the tests here compute JAX's results in this process
from the same numpy-seeded inputs.  Two cases meet JAX's own
``SpatialNUFFT(engine='split')`` on the 8-device CPU mesh (3D complex128
replicated, and ``spectrum='sharded'``); the others meet JAX's single-device
plan on its reference path, to which JAX's tests hold its spatial mode.  The
point-sharded mode meets JAX's ``exec_type{1,2}_sharded`` on a 4-device
mesh.  Tolerance: JAX's own, rtol 1e-10 and atol 1e-12
(``test_spatial.py:67``).
"""

import math

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import nonuniformffts_tpu as jnufft
from nonuniformffts_tpu.execution import exec_type1_channels, exec_type2_channels
from nonuniformffts_tpu.parallel import SpatialNUFFT as JaxSpatialNUFFT
from nonuniformffts_tpu.parallel import exec_type1_sharded, exec_type2_sharded, make_mesh
from nonuniformffts_tpu.parallel import shard_points as jax_shard_points
from torch_parallel_workers import (AGREE_CASES, CASES, ENGINE_CASES, GROUPED_SHARDED_CASES,
                                    SHARDED_CASES, UNEVEN_SHARDED_CASES, case_inputs,
                                    run_ranks)

TOL = dict(rtol=1e-10, atol=1e-12)
N4 = ("c128_n4", "c128_sharded", "c128_sharded_auto", "f64_r2c", "c128_2d", "c128_30",
      "f64_2d", "f64_2d_sharded", "skewed", "ntransforms", "ntransforms_sharded",
      "f64_sharded", "f64_sharded_split", "errors", "engines", "pts_c128", "pts_f64")
N2 = ("c128_n2", "f64_r2c_n2")
N1 = ("c128_n1_fftshift",)
# Groups of transforms, the device census and the slab model, run in the
# n = 4 and n = 2 spawns above.
GROUPS4 = ("c128_groups", "c128_groups_sharded", "c128_groups_split", "pts_c128_groups")
GROUPS2 = ("f64_groups_n2", "pts_f64_groups_n2")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The results of every case, by group size and name."""
    out = {}
    for n, names in ((4, N4 + GROUPS4 + AGREE_CASES + ("sharing", "slab_model")),
                     (2, N2 + ("errors",) + GROUPS2 + ("sharing",)), (1, N1)):
        out[n] = run_ranks(n, names, str(tmp_path_factory.mktemp(f"ranks{n}")))
    return out


def _results(ranks, n, name):
    res = ranks[n][name]
    for r, x in enumerate(res):
        assert "failed" not in x, f"rank {r}:\n{x['failed']}"
    return res


def _single_reference(name, n):
    """JAX's single-device plan (reference path) on all of the case's points:
    its channel spectrum and its type-2 values of that spectrum."""
    case = CASES[name]
    kw = {k: v for k, v in case["spatial"].items()
          if k not in ("capacity_factor", "spectrum", "engine")}
    pts, v_ch = case_inputs(name, n)
    plan = jnufft.set_points(
        jnufft.PlanNUFFT(case["dtype"], case["shape"], spread_method="reference",
                         fft_method="xla", **kw),
        pts)
    u = np.asarray(exec_type1_channels(plan, v_ch))
    return u, np.asarray(exec_type2_channels(plan, u))


def _shard(u, rank, x):
    """Rank ``rank``'s shard of the channel spectrum ``u`` along the dim its
    result ``x`` reports."""
    d = x["shard_dim"]
    k = x["k0_local"] if d == 0 else x["k1_local"]
    return np.take(u, np.arange(rank * k, (rank + 1) * k), axis=2 + d)


def _check_against(res, u_ref, v2_ref, n, sharded=False):
    for r, x in enumerate(res):
        np_ = v2_ref.shape[-1] // n
        want_u = _shard(u_ref, r, x) if sharded else u_ref
        np.testing.assert_allclose(x["u"].numpy(), want_u, **TOL)
        np.testing.assert_allclose(x["v2"].numpy(), v2_ref[..., r * np_ : (r + 1) * np_], **TOL)


def _jax_spatial(name, n, engine="split"):
    """JAX's SpatialNUFFT (interpret mode) on an n-device mesh."""
    case = CASES[name]
    sp_kw = {k: v for k, v in case["spatial"].items() if k not in ("capacity_factor", "engine")}
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("grid",))
    sp = JaxSpatialNUFFT(case["dtype"], case["shape"], mesh=mesh, interpret=True,
                         engine=engine, **sp_kw)
    pts, v_ch = case_inputs(name, n)
    st = sp.set_points(pts)
    u = np.asarray(sp.exec_type1(st, v_ch))
    return u, np.asarray(sp.exec_type2(st, sp.exec_type1(st, v_ch)))


def test_complex128_n4_matches_jax_spatial(ranks):
    res = _results(ranks, 4, "c128_n4")
    u, v2 = _jax_spatial("c128_n4", 4)
    _check_against(res, u, v2, 4)
    # 'auto' picks block form for a z-form plan, as the JAX package does.
    assert all(x["engine"] == "blockform" and x["shard_dim"] == 0 for x in res)


def test_spectrum_sharded_matches_jax_spatial_and_replicated(ranks):
    res = _results(ranks, 4, "c128_sharded")
    u, v2 = _jax_spatial("c128_sharded", 4)  # the global array of the shards
    _check_against(res, u, v2, 4, sharded=True)
    u_rep, v2_rep = _single_reference("c128_sharded", 4)
    _check_against(res, u_rep, v2_rep, 4, sharded=True)
    k1l = res[0]["k1_local"]
    assert tuple(res[0]["u"].shape) == (1, 2, 16, k1l, 16) and k1l == 4
    assert all(x["engine"] == "split" and x["shard_dim"] == 1 for x in res)
    b = res[0]["bytes"]
    assert b["spectrum"] == "sharded" and b["n"] == 4 and b["t1_spectrum_all_gather"] == 0


def test_blockform_spectrum_sharded_matches_jax_default_engine(ranks):
    """'auto' with spectrum='sharded': dim-0 shards, equal to JAX's default
    engine (block form) and to the single-device plan."""
    res = _results(ranks, 4, "c128_sharded_auto")
    assert all(x["engine"] == "blockform" and x["shard_dim"] == 0 for x in res)
    assert tuple(res[0]["u"].shape) == (1, 2, 4, 16, 16)
    u, v2 = _jax_spatial("c128_sharded_auto", 4, engine="auto")
    _check_against(res, u, v2, 4, sharded=True)
    _check_against(res, *_single_reference("c128_sharded_auto", 4), 4, sharded=True)
    b = res[0]["bytes"]
    assert b["t1_unshard_all_to_all"] == b["t2_shard_all_to_all"] == 3 * 4 * 4 * 16 * 16


@pytest.mark.parametrize("name", ["f64_r2c", "c128_2d", "skewed", "ntransforms"])
def test_spatial_n4_matches_single_device(ranks, name):
    _check_against(_results(ranks, 4, name), *_single_reference(name, 4), 4)


@pytest.mark.parametrize("name", ["c128_30", "f64_2d"])
def test_padded_dim1_matches_single_device(ranks, name):
    """Spectral dim 1 that n does not divide (30 modes; a real 2D plan's
    N1 / 2 + 1 = 11) runs padded to a multiple of n."""
    res = _results(ranks, 4, name)
    assert res[0]["engine"] == "blockform"
    assert res[0]["k1_local"] == {"c128_30": 8, "f64_2d": 3}[name]
    _check_against(res, *_single_reference(name, 4), 4)


@pytest.mark.parametrize("name", ["f64_sharded", "f64_2d_sharded", "ntransforms_sharded",
                                  "f64_sharded_split"])
def test_real_spectrum_sharded_matches_single_device(ranks, name):
    """Block form's dim-0 shards (real plans in 3D and 2D, two transforms),
    and the split engine's dim-1 shards of a real plan."""
    res = _results(ranks, 4, name)
    split = CASES[name]["spatial"].get("engine") == "split"
    assert all(x["engine"] == ("split" if split else "blockform")
               and x["shard_dim"] == (1 if split else 0) for x in res)
    _check_against(res, *_single_reference(name, 4), 4, sharded=True)


def test_engine_and_shard_dim_match_jax(ranks):
    """Construction only: ``engine`` and ``spectrum_shard_dim`` equal the
    JAX package's for each kwargs set, and both raise the same error on the
    same sets."""
    res = _results(ranks, 4, "engines")
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("grid",))
    for key, (dtype, shape, kw) in ENGINE_CASES.items():
        try:
            sp = JaxSpatialNUFFT(dtype, shape, mesh=mesh, interpret=True, m=4, sigma=1.5, **kw)
            want = (sp.engine, sp.spectrum_shard_dim)
        except ValueError as e:
            want = str(e)
        for x in res:
            assert x[key] == want, (key, x[key], want)
    assert sum(isinstance(x, str) for x in res[0].values()) == 2


def test_sharded_dim0_indivisible_raises(ranks):
    """(33, 32, 32) at n = 2 with spectrum='sharded': block form shards
    dim 0, whose 33 modes do not split (test_spatial.py:302)."""
    for x in _results(ranks, 2, "errors"):
        assert x["dim0"] is not None and "spectral dim 0 (33)" in x["dim0"], x["dim0"]


@pytest.mark.parametrize("name", N2)
def test_spatial_n2_matches_single_device(ranks, name):
    """Two ranks: both neighbours of a rank are the same rank."""
    _check_against(_results(ranks, 2, name), *_single_reference(name, 2), 2)


def test_spatial_n1_fftshift_matches_single_device(ranks):
    """One rank: the halo wraps onto the rank's own slab; fftshift order."""
    _check_against(_results(ranks, 1, "c128_n1_fftshift"),
                   *_single_reference("c128_n1_fftshift", 1), 1)


def test_collective_bytes_split_formula(ranks):
    """Bytes a rank sends: three of its four (6, 4, 16) complex128 blocks of
    the transposes, and its (16, 4, 16) dim-1 shard to three ranks."""
    b = _results(ranks, 4, "c128_n4")[0]["bytes"]
    assert b["t1_transpose_all_to_all"] == b["t2_transpose_all_to_all"] == 3 * 6 * 4 * 16 * 16
    assert b["t1_spectrum_all_gather"] == 3 * 16 * 4 * 16 * 16


ERRORS = {
    "ndim": ">= 2 dimensions",
    "spectrum": "unknown spectrum layout",
    "engine": "unknown SpatialNUFFT engine",
    "variant": "requires fft_variant='split'",
    "slab": "cannot split 16 grid planes",
    "dim1": "must divide by the mesh size",
    "indivisible": "spectral dim",
    "npoints": "divide by mesh size",
    "overflow": "overflow",
}


@pytest.mark.parametrize("key", sorted(ERRORS))
def test_errors_raise_on_every_rank(ranks, key):
    """Validation errors, the unequal point counts and the routing overflow
    raise the same ValueError on every rank, none hangs, and the group
    still works after them."""
    res = _results(ranks, 4, "errors")
    for x in res:
        assert x[key] is not None and ERRORS[key] in x[key], x[key]
        assert np.isfinite(x["ok_after"]) and x["ok_after"] > 0


@pytest.mark.parametrize("name", sorted(SHARDED_CASES))
def test_point_sharded_matches_jax(ranks, name):
    res = _results(ranks, 4, name)
    case = SHARDED_CASES[name]
    pts, v_ch = case_inputs(name, 4)
    mesh = make_mesh(4)
    plan = jnufft.PlanNUFFT(case["dtype"], case["shape"], sigma=2.0, fft_method="xla")
    pts_d, v_d = jax_shard_points(mesh, pts, v_ch)
    u = np.asarray(exec_type1_sharded(plan, pts_d, v_d, mesh=mesh))
    v2 = np.asarray(exec_type2_sharded(plan, pts_d, u, mesh=mesh))
    for r, x in enumerate(res):
        np.testing.assert_allclose(x["u"].numpy(), u, **TOL)
        np_ = case["np_rank"]
        np.testing.assert_allclose(x["v2"].numpy(), v2[..., r * np_ : (r + 1) * np_], **TOL)


# ---------------------------------------------------------------------------
# Groups of transforms (the slab plan's / the plan's transform_chunk)
# ---------------------------------------------------------------------------


def _grouped_n(name):
    return 4 if name in GROUPS4 else 2


@pytest.mark.parametrize("name", [k for k in GROUPS4 + GROUPS2 if k in CASES])
def test_spatial_groups_match_one_pass_and_single_device(ranks, name):
    """C = 3 transforms with the slab plan's ``transform_chunk`` forced to
    2 (groups of 2 and 1, each through the whole chain): equal to the one
    pass and to JAX's single-device reference plan, replicated and in both
    engines' shards.  CPU plans choose no group size."""
    n = _grouped_n(name)
    res = _results(ranks, n, name)
    sharded = CASES[name]["spatial"].get("spectrum") == "sharded"
    u_ref, v2_ref = _single_reference(name, n)
    grouped = [dict(x, u=x["u_grouped"], v2=x["v2_grouped"]) for x in res]
    _check_against(grouped, u_ref, v2_ref, n, sharded=sharded)
    _check_against(res, u_ref, v2_ref, n, sharded=sharded)
    for x in res:
        assert x["transform_chunk"] is None
        np.testing.assert_allclose(x["u_grouped"].numpy(), x["u"].numpy(), **TOL)
        np.testing.assert_allclose(x["v2_grouped"].numpy(), x["v2"].numpy(), **TOL)
        assert x["u_grouped"].shape == x["u"].shape and x["u_grouped"].shape[0] == 3


@pytest.mark.parametrize("name", sorted(GROUPED_SHARDED_CASES))
def test_point_sharded_groups_match_one_pass_and_single_device(ranks, name):
    """The point-sharded mode at C = 3 with the plan's ``transform_chunk``
    forced to 2, against its one pass and JAX's single-device reference
    plan on all the points."""
    n = _grouped_n(name)
    res = _results(ranks, n, name)
    case = GROUPED_SHARDED_CASES[name]
    pts, v_ch = case_inputs(name, n)
    plan = jnufft.set_points(
        jnufft.PlanNUFFT(case["dtype"], case["shape"], sigma=2.0, ntransforms=case["C"],
                         spread_method="reference", fft_method="xla"), pts)
    u_ref = np.asarray(exec_type1_channels(plan, v_ch))
    v2_ref = np.asarray(exec_type2_channels(plan, u_ref))
    np_ = case["np_rank"]
    for r, x in enumerate(res):
        for u, v2 in ((x["u"], x["v2"]), (x["u_grouped"], x["v2_grouped"])):
            np.testing.assert_allclose(u.numpy(), u_ref, **TOL)
            np.testing.assert_allclose(v2.numpy(), v2_ref[..., r * np_ : (r + 1) * np_], **TOL)
        np.testing.assert_allclose(x["u_grouped"].numpy(), x["u"].numpy(), **TOL)
        np.testing.assert_allclose(x["v2_grouped"].numpy(), x["v2"].numpy(), **TOL)


@pytest.mark.parametrize("n", [4, 2])
def test_ranks_on_one_device_are_counted(ranks, n):
    """Ranks on one host's CPU count as sharing one device: each rank of
    the group finds n, by ``comm.ranks_on_device`` and in the spatial
    ``set_points``' census."""
    for x in _results(ranks, n, "sharing"):
        assert x == dict(ranks_on_device=n, spatial=n)


@pytest.mark.parametrize("key", ["c128_replicated", "c64_sharded", "c128_split", "f64_2d"])
def test_slab_model_fits_its_budget(ranks, key):
    """The spatial rank's model (``SpatialNUFFT.slab_model``): a transform
    holds at least its extended slab, the FFT'd slab, the columns and the
    gathered spectrum; the chosen group is the largest whose working set
    fits ``TRANSFORM_MEMORY_FRACTION`` of the rank's budget; and the slab
    model a transform is below the single-card plan's at the same
    arguments (the slab is O(grid / n))."""
    from nonuniformffts_tpu_torch import plan as tplan

    for x in _results(ranks, 4, "slab_model"):
        res = x[key]
        kw = res["model"]
        C = kw["ntransforms"]
        assert tuple(kw["shape_over"]) == tuple(res["ext_shape_over"])
        assert tuple(kw["spectral_shape"]) == tuple(res["output_shape"])
        ws = tplan.transform_working_set(**kw)
        real_bytes = torch.finfo(tplan._REAL_OF[kw["dtype"]]).bits // 8
        value_bytes = real_bytes * (2 if kw["dtype"].is_complex else 1)
        held = (math.prod(res["ext_shape_over"]) * value_bytes
                + sum(math.prod(s) for s in (kw["spectral_shape_over"],) + kw["slab_buffers"])
                * 2 * real_bytes)
        assert ws.per_transform >= held
        single = tplan.transform_working_set(
            res["global_shape_over"], res["global_spectral_shape_over"],
            res["global_spectral_shape"], kw["dtype"], C, 4 * 200)
        assert ws.per_transform < single.per_transform
        for gib in (0.001, 0.01, 0.05, 1.0):
            device = int(gib * 2**30)
            budget = int(tplan.TRANSFORM_MEMORY_FRACTION * device)
            g = tplan.choose_transform_chunk(device_bytes=device, **kw)
            if g is None:
                assert ws.total(C) <= budget
                continue
            assert 1 <= g < C and ws.total(g + 1) > budget
            assert g == 1 or ws.total(g) <= budget


@pytest.mark.parametrize("name", AGREE_CASES)
def test_ranks_agree_on_one_group_size(ranks, name):
    """On a fabricated card the four ranks choose different group sizes:
    in the spatial mode every point lies in rank 0's slab, so that rank 0
    holds more point state than the others; in the point-sharded mode the
    ranks hold 1 : 2 : 3 : 4 of the points.  Every rank runs the smallest
    choice, whose collectives pair up, and the grouped results equal the
    one pass and JAX's single-device reference plan.  The point-sharded
    type 2, which runs no collective a group, keeps each rank's own."""
    res = _results(ranks, 4, name)
    own = [x["own"] for x in res]
    assert len(set(own)) > 1 and min(own) >= 1
    assert all(x["agreed"] == min(own) for x in res)
    if name in UNEVEN_SHARDED_CASES:
        case = UNEVEN_SHARDED_CASES[name]
        pts, v_ch = case_inputs(name, 4)
        plan = jnufft.set_points(
            jnufft.PlanNUFFT(case["dtype"], case["shape"], sigma=2.0, ntransforms=case["C"],
                             spread_method="reference", fft_method="xla"), pts)
        u_ref = np.asarray(exec_type1_channels(plan, v_ch))
        v2_ref = np.asarray(exec_type2_channels(plan, u_ref))
        assert len({b - a for a, b in (x["bounds"] for x in res)}) == 4
        for x in res:
            assert x["type2_chunk"] == x["own"]
            a, b = x["bounds"]
            for u, v2 in ((x["u"], x["v2"]), (x["u_grouped"], x["v2_grouped"])):
                np.testing.assert_allclose(u.numpy(), u_ref, **TOL)
                np.testing.assert_allclose(v2.numpy(), v2_ref[..., a:b], **TOL)
    else:
        assert res[0]["received"] > 0 and all(x["received"] == 0 for x in res[1:])
        u_ref, v2_ref = _single_reference(name, 4)
        _check_against(res, u_ref, v2_ref, 4)
        _check_against([dict(x, u=x["u_grouped"], v2=x["v2_grouped"]) for x in res],
                       u_ref, v2_ref, 4)
    for x in res:
        np.testing.assert_allclose(x["u_grouped"].numpy(), x["u"].numpy(), **TOL)
        np.testing.assert_allclose(x["v2_grouped"].numpy(), x["v2"].numpy(), **TOL)
