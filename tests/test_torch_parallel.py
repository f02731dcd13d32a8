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

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import nonuniformffts_tpu as jnufft
from nonuniformffts_tpu.execution import exec_type1_channels, exec_type2_channels
from nonuniformffts_tpu.parallel import SpatialNUFFT as JaxSpatialNUFFT
from nonuniformffts_tpu.parallel import exec_type1_sharded, exec_type2_sharded, make_mesh
from nonuniformffts_tpu.parallel import shard_points as jax_shard_points
from torch_parallel_workers import CASES, ENGINE_CASES, SHARDED_CASES, case_inputs, run_ranks

TOL = dict(rtol=1e-10, atol=1e-12)
N4 = ("c128_n4", "c128_sharded", "c128_sharded_auto", "f64_r2c", "c128_2d", "c128_30",
      "f64_2d", "f64_2d_sharded", "skewed", "ntransforms", "ntransforms_sharded",
      "f64_sharded", "f64_sharded_split", "errors", "engines", "pts_c128", "pts_f64")
N2 = ("c128_n2", "f64_r2c_n2")
N1 = ("c128_n1_fftshift",)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The results of every case, by group size and name."""
    out = {}
    for n, names in ((4, N4), (2, N2 + ("errors",)), (1, N1)):
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
