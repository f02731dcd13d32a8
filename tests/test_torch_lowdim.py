"""1D and 2D plans of the port against the JAX package's yz-form kernels.

Every 1D plan, and every plan with the default ``fft_method`` off the TPU,
runs the JAX package's yz-form ``_spread_kernel`` / ``_interp_kernel``
(``ops/pallas/blocked.py``, here in interpret mode; each test asserts
``kernel_form == 'yz'``).  The port's blocked wrappers run the plain
versions of the kernels that replace them (``nufft_{spread,interp}_{1,2}d_*``,
K4/K5) on CPU tensors.  2D 64-bit plans are also held against the JAX
double-single pipeline (``_spread_kernel_ds`` / ``_interp_kernel_ds``,
``precision='double'``), and one 3D case against the yz form, since the 3D
kernels compute the yz kernels' function too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.interop import plan_data_from_numpy
from nonuniformffts_tpu_torch.ops.deconvolve import output_wavenumbers
from nufft_test_utils import direct_type1
from torch_port_utils import random_complex, real_dtype, rel_err

torch.set_num_threads(1)

# float32 on both sides, summed in another order; float64 on both sides.
TOL = {4: 1e-5, 8: 1e-12}
# Against the JAX double-single pipeline: its (hi, lo) pairs carry ~48 bits
# (tests/test_ds.py).
TOL_DS = 5e-11
# Against the exact sums: the m = 4, sigma = 1.5 window error is ~1-2e-6.
TOL_EXACT = 1e-5
DTYPES = [np.complex64, np.complex128, np.float32, np.float64]
NP = 300


def _inputs(rng, dtype, shape, spectral_shape, C, np_=NP):
    """Points (in the plan's real dtype, some at nextafter(2pi, 0) and some
    outside [0, 2pi)), values of the plan's dtype and a spectrum of its
    complex dtype, with a leading axis of C when C > 1."""
    real = real_dtype(dtype)
    pts = rng.uniform(-2 * np.pi, 4 * np.pi, (len(shape), np_)).astype(real)
    pts[:, :8] = np.nextafter(real.type(2 * np.pi), real.type(0))
    v = random_complex(rng, np.complex128, (C, np_))
    v = (v if np.dtype(dtype).kind == "c" else v.real).astype(dtype)
    cdt = np.complex64 if real == np.float32 else np.complex128
    u = random_complex(rng, cdt, (C,) + spectral_shape)
    return (pts, v, u) if C > 1 else (pts, v[0], u[0])


def _run(pkg, plan, pts, v, u):
    plan = pkg.set_points(plan, pts)
    out = (pkg.exec_type1(plan, v), pkg.exec_type2(plan, u))
    return tuple(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in out)


def _tol(dtype):
    return TOL[real_dtype(dtype).itemsize]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("shape", [(40,), (16, 12)], ids=str)
def test_blocked_matches_jax_yz_kernels(shape, m, dtype):
    """Type 1 and type 2 of a 1D or 2D blocked plan (block dims from the
    chooser) against the JAX blocked plan, which runs the yz-form kernels;
    ntransforms = 2 at m = 4, 1 otherwise.  m = 8 runs at sigma = 2 (the
    accuracy point of chip_smoke.py phase 5): at sigma = 1.5 float32
    evaluation of its window leaves both packages 1.3-3.1e-5 from the exact
    sums at (16, 12), against ~6e-7 at sigma = 2."""
    C = 2 if m == 4 else 1
    kw = dict(m=m, sigma=2.0 if m == 8 else 1.5, ntransforms=C, spread_method="blocked")
    tp = tnufft.PlanNUFFT(dtype, shape, device="cpu", **kw)
    jp = jnufft.PlanNUFFT(dtype, shape, interpret=True, **kw)
    assert jp.kernel_form == "yz"
    assert tp.shape_over == jp.shape_over
    pts, v, u = _inputs(np.random.default_rng(100 + m), dtype, shape, tp.spectral_shape, C)
    u1, v2 = _run(tnufft, tp, pts, v, u)
    ju1, jv2 = _run(jnufft, jp, pts, v, u)
    assert u1.shape == ju1.shape and v2.shape == jv2.shape
    assert u1.dtype == (np.complex64 if real_dtype(dtype) == np.float32 else np.complex128)
    assert v2.dtype == np.dtype(dtype)
    assert rel_err(u1, ju1) <= _tol(dtype)
    assert rel_err(v2, jv2) <= _tol(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.float64], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape,block_dims", [((48,), (12,)), ((16, 20), (6, 10))], ids=str)
def test_blocked_explicit_block_dims_match_jax(shape, block_dims, dtype):
    """The same with block dims given explicitly to the port."""
    kw = dict(m=4, sigma=1.5, spread_method="blocked")
    tp = tnufft.PlanNUFFT(dtype, shape, device="cpu", block_dims=block_dims, **kw)
    jp = jnufft.PlanNUFFT(dtype, shape, interpret=True, **kw)
    assert jp.kernel_form == "yz" and tp.block_dims == block_dims
    pts, v, u = _inputs(np.random.default_rng(7), dtype, shape, tp.spectral_shape, 1)
    u1, v2 = _run(tnufft, tp, pts, v, u)
    ju1, jv2 = _run(jnufft, jp, pts, v, u)
    assert rel_err(u1, ju1) <= _tol(dtype)
    assert rel_err(v2, jv2) <= _tol(dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("C", [1, 2])
def test_2d_64bit_matches_jax_ds(dtype, C):
    """2D 64-bit blocked plans against the JAX double-single pipeline at
    m = 6, sigma = 2 (as tests/test_ds.py:171,235)."""
    shape, np_ = (24, 20), 800
    kw = dict(m=6, sigma=2.0, ntransforms=C, spread_method="blocked", precision="double")
    tp = tnufft.PlanNUFFT(dtype, shape, device="cpu", **kw)
    jp = jnufft.PlanNUFFT(dtype, shape, interpret=True, np_hint=np_, **kw)
    assert jp.ds and jp.kernel_form == "yz"
    pts, v, u = _inputs(np.random.default_rng(80 + C), dtype, shape, tp.spectral_shape,
                        C, np_)
    u1, v2 = _run(tnufft, tp, pts, v, u)
    ju1, jv2 = _run(jnufft, jp, pts, v, u)
    assert rel_err(u1, ju1) <= TOL_DS
    assert rel_err(v2, jv2) <= TOL_DS


@pytest.mark.parametrize("dtype", [np.complex64, np.float64], ids=lambda d: np.dtype(d).name)
def test_3d_matches_jax_yz_form(dtype):
    """The 3D kernels compute the yz-form kernels' function too."""
    shape = (12, 10, 16)
    kw = dict(m=4, sigma=1.5, spread_method="blocked")
    tp = tnufft.PlanNUFFT(dtype, shape, device="cpu", **kw)
    jp = jnufft.PlanNUFFT(dtype, shape, interpret=True, fft_method="xla", **kw)
    assert jp.kernel_form == "yz"
    pts, v, u = _inputs(np.random.default_rng(9), dtype, shape, tp.spectral_shape, 1)
    u1, v2 = _run(tnufft, tp, pts, v, u)
    ju1, jv2 = _run(jnufft, jp, pts, v, u)
    assert rel_err(u1, ju1) <= _tol(dtype)
    assert rel_err(v2, jv2) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(40,), (16, 12)], ids=str)
def test_points_shifted_by_two_pi(shape, dtype):
    """Points at nextafter(2pi, 0) stay in bounds, and points shifted by
    multiples of 2pi give the same transforms: type 1 against the exact
    sums either way, type 2 shifted against unshifted.  Both within the
    m = 4, sigma = 1.5 window error: a point at nextafter(2pi, 0) shifted
    by 2pi rounds to 4pi, so it is evaluated at X = 0 of cell 0 instead of
    X ~ 1 of cell n - 1, where the window's fit differs by ~1e-6."""
    tp = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, spread_method="blocked",
                          device="cpu")
    rng = np.random.default_rng(11)
    pts, v, u = _inputs(rng, dtype, shape, tp.spectral_shape, 1)
    real = real_dtype(dtype)
    pts = np.mod(pts.astype(np.float64), 2 * np.pi).astype(real)
    pts[:, :8] = np.nextafter(real.type(2 * np.pi), real.type(0))
    shifted = (pts + 2 * np.pi * rng.integers(-2, 3, (len(shape), 1))).astype(real)
    kv = [output_wavenumbers(n, r2c=tp.is_real and d == len(shape) - 1, fftshift=False)
          for d, n in enumerate(shape)]
    u1, v2 = _run(tnufft, tp, pts, v, u)
    su1, sv2 = _run(tnufft, tp, shifted, v, u)
    assert np.isfinite(u1).all() and np.isfinite(v2).all()
    for p, got in ((pts, u1), (shifted, su1)):
        assert rel_err(got, direct_type1(p.astype(np.float64), v, kv)) <= TOL_EXACT
    assert rel_err(sv2, v2) <= TOL_EXACT


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(40,), (16, 12)], ids=str)
def test_interop_from_jax_lowdim_plan(shape, dtype):
    """A JAX 1D or 2D plan's coefficients, deconvolution factors and index
    ranges (a real plan's halved last axis included) carry into the port
    and give the port's own transforms."""
    kw = dict(m=4, sigma=1.5, spread_method="blocked")
    jp = jnufft.PlanNUFFT(dtype, shape, interpret=True, **kw)
    tp = tnufft.PlanNUFFT(dtype, shape, device="cpu", **kw)
    data = plan_data_from_numpy(
        kind=jp.kernel_data[0].kind,
        cs_poly=[np.asarray(kd.cs_poly) for kd in jp.kernel_data],
        beta=[kd.beta for kd in jp.kernel_data],
        peak=[kd.peak for kd in jp.kernel_data],
        phihat_inv=[np.asarray(p) for p in jp.phihat_inv],
        index_ranges=jp.index_ranges,
        shape_over=jp.shape_over,
        dtype=tp.real_dtype,
    )
    assert data["shape_over"] == tp.shape_over
    assert data["index_ranges"] == tp.index_ranges
    assert [len(p) for p in data["phihat_inv"]] == list(tp.spectral_shape)
    tol = _tol(dtype)
    assert rel_err(data["coefs"].numpy(), tp.coefs.numpy()) <= tol
    for a, b in zip(data["phihat_inv"], tp.phihat_inv):
        assert rel_err(a.numpy(), b.numpy()) <= tol
    pts, v, u = _inputs(np.random.default_rng(12), dtype, shape, tp.spectral_shape, 1)
    own = _run(tnufft, tp, pts, v, u)
    carried = _run(tnufft, dataclasses.replace(tp, **data), pts, v, u)
    for a, b in zip(carried, own):
        assert rel_err(a, b) <= tol
