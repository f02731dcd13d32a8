"""The port's real-data (r2c/c2r) plans on the CPU: float64 blocked plans
against the JAX package's real double-single pipeline and its float64
reference path, float32 blocked plans against JAX's real z-form kernels, and
the conventions of the halved last axis (positive Nyquist, c2r doubling).

The port's blocked wrappers run the plain versions of
``nufft_spread_3d_real_f64`` / ``nufft_interp_3d_real_f64`` (replacing
``_spread_kernel_ds`` / ``_interp_kernel_ds`` on real rows) and of the
``*_real_f32`` entry points (``_spread_kernel_z`` / ``_interp_kernel_z`` on
real rows) on CPU tensors.
"""

import functools

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.ops.deconvolve import output_wavenumbers
from nufft_test_utils import direct_type1, direct_type2_real
from torch_port_utils import random_complex, rel_err

torch.set_num_threads(1)

TOL_DS = 5e-11  # the JAX ds pairs carry ~48 bits (tests/test_ds.py)
TOL_F64 = 1e-10  # native float64 on both sides
TOL_F32 = 1e-5  # float32 on both sides, summed in another order
TOL_EXACT = 1e-5  # m = 4, sigma = 1.5 window error is ~2e-6
SHAPE, M, SIGMA, NP = (24, 24, 24), 6, 2.0, 1500


def _run(pkg, plan, pts, v, u):
    plan = pkg.set_points(plan, pts)
    out = (pkg.exec_type1(plan, v), pkg.exec_type2(plan, u))
    return tuple(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in out)


@functools.lru_cache(maxsize=None)
def _outputs_f64(C: int):
    """Type 1 and type 2 of the port's blocked float64 plan, the JAX real
    ds plan and the JAX float64 reference plan on the same seeded inputs."""
    rng = np.random.default_rng(50 + C)
    pts = rng.uniform(0, 2 * np.pi, (3, NP))
    v = rng.standard_normal((C, NP))
    spec = SHAPE[:-1] + (SHAPE[-1] // 2 + 1,)
    u = random_complex(rng, np.complex128, (C,) + spec)
    kw = dict(m=M, sigma=SIGMA, ntransforms=C)
    tp = tnufft.PlanNUFFT(np.float64, SHAPE, spread_method="blocked",
                          precision="double", device="cpu", **kw)
    dsp = jnufft.PlanNUFFT(np.float64, SHAPE, spread_method="blocked",
                           precision="double", interpret=True, np_hint=NP, **kw)
    assert dsp.ds and dsp.is_real and tp.is_real
    assert tp.shape_over == dsp.shape_over and tp.spectral_shape == spec
    ref = jnufft.PlanNUFFT(np.float64, SHAPE, **kw)
    return {"port": _run(tnufft, tp, pts, v, u), "ds": _run(jnufft, dsp, pts, v, u),
            "ref": _run(jnufft, ref, pts, v, u)}


@pytest.mark.parametrize("C", [1, 2])
def test_float64_blocked_matches_jax_ds(C):
    out = _outputs_f64(C)
    u1, v2 = out["port"]
    assert u1.dtype == np.complex128 and v2.dtype == np.float64
    assert u1.shape == (C, 24, 24, 13) and v2.shape == (C, NP)
    assert rel_err(u1, out["ds"][0]) <= TOL_DS
    assert rel_err(v2, out["ds"][1]) <= TOL_DS


@pytest.mark.parametrize("C", [1, 2])
def test_float64_blocked_matches_jax_f64_reference(C):
    out = _outputs_f64(C)
    assert rel_err(out["port"][0], out["ref"][0]) <= TOL_F64
    assert rel_err(out["port"][1], out["ref"][1]) <= TOL_F64


@pytest.mark.parametrize("C", [1, 2])
def test_float32_blocked_matches_jax_z_form(C):
    """float32 real plans against JAX's real-row z-form kernels
    (``_spread_kernel_z`` / ``_interp_kernel_z``) in interpret mode, and
    against the exact sums."""
    rng = np.random.default_rng(60 + C)
    shape = (16, 16, 16)
    kw = dict(m=4, sigma=1.5, ntransforms=C)
    pts = rng.uniform(0, 2 * np.pi, (3, 400)).astype(np.float32)
    v = rng.standard_normal((C, 400)).astype(np.float32)
    u = random_complex(rng, np.complex64, (C, 16, 16, 9))
    u[..., 8] = 0  # the c2r oracle below mirrors no +N/2 plane
    tp = tnufft.PlanNUFFT(np.float32, shape, spread_method="blocked", device="cpu", **kw)
    jp = jnufft.PlanNUFFT(np.float32, shape, spread_method="blocked", interpret=True,
                          fft_method="matmul", fft_variant="pruned", **kw)
    assert jp.kernel_form == "z" and tp.shape_over == jp.shape_over
    u1, v2 = _run(tnufft, tp, pts, v, u)
    ju1, jv2 = _run(jnufft, jp, pts, v, u)
    assert u1.dtype == np.complex64 and v2.dtype == np.float32
    assert rel_err(u1, ju1) <= TOL_F32
    assert rel_err(v2, jv2) <= TOL_F32
    x = pts.astype(np.float64)
    kv = [output_wavenumbers(n, r2c=d == 2, fftshift=False) for d, n in enumerate(shape)]
    for c in range(C):
        assert rel_err(u1[c], direct_type1(x, v[c], kv)) <= TOL_EXACT
        assert rel_err(v2[c], direct_type2_real(x, u[c], kv, 16)) <= TOL_EXACT


@pytest.mark.parametrize("method", ["reference", "blocked"])
def test_r2c_halved_axis_nyquist_convention(method):
    """Port copy of tests/test_accuracy.py::test_r2c_halved_axis_nyquist_
    convention: the halved LAST axis holds k = 0..+N/2 with a POSITIVE
    Nyquist mode, and the c2c plan agrees with the r2c slab below Nyquist."""
    rng = np.random.default_rng(70)
    N, Np = 32, 3000
    pts = rng.uniform(0, 2 * np.pi, (3, Np))
    v = rng.standard_normal(Np)
    opts = dict(m=6, sigma=2.0, spread_method=method, device="cpu")
    p = tnufft.set_points(tnufft.PlanNUFFT(np.float64, (N,) * 3, **opts), pts)
    u = tnufft.exec_type1(p, v).numpy()
    assert u.shape == (N, N, N // 2 + 1)
    for k0, k1 in [(3, 7), (N // 2, 2), (0, N - 1)]:
        kv0 = k0 - N if k0 >= (N + 1) // 2 else k0
        kv1 = k1 - N if k1 >= (N + 1) // 2 else k1
        exact_pos = np.sum(
            v * np.exp(-1j * (kv0 * pts[0] + kv1 * pts[1] + (N // 2) * pts[2]))
        )
        got = u[k0, k1, N // 2]
        assert abs(got - exact_pos) / abs(exact_pos) < 1e-5, (k0, k1)
    pc = tnufft.set_points(tnufft.PlanNUFFT(np.complex128, (N,) * 3, **opts), pts)
    uc = tnufft.exec_type1(pc, v.astype(np.complex128)).numpy()
    assert rel_err(u[:, :, : N // 2], uc[:, :, : N // 2]) < 1e-5


@pytest.mark.parametrize("method", ["reference", "blocked"])
def test_c2r_type2_rank1_oracle_convention(method):
    """Port copy of tests/test_accuracy.py::test_c2r_type2_rank1_oracle_
    convention: v(x) = Re(sum_{k2=0} u e^{ikx}) + 2 Re(sum_{k2>0} u e^{ikx}),
    the stored +N/2 plane included; a Hermitian rank-1 spectrum whose full
    axes have a zero Nyquist bin has a product of real factor sums as its
    exact value."""
    rng = np.random.default_rng(71)
    N, Np = 16, 500
    H = N // 2 + 1
    pts = rng.uniform(0, 2 * np.pi, (3, Np))

    def herm_full(n):
        a = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / n
        a[0] = a[0].real
        a[n // 2] = 0.0
        a[n // 2 + 1 :] = np.conj(a[1 : n // 2][::-1])
        return a

    a0, a1 = herm_full(N), herm_full(N)
    a2h = (rng.standard_normal(H) + 1j * rng.standard_normal(H)) / N
    a2h[0] = a2h[0].real
    u = np.einsum("a,b,c->abc", a0, a1, a2h)
    p = tnufft.set_points(
        tnufft.PlanNUFFT(np.float64, (N,) * 3, m=6, sigma=2.0, spread_method=method,
                         device="cpu"), pts)
    v = tnufft.exec_type2(p, u).numpy()
    kfull = np.fft.fftfreq(N, 1.0 / N)
    exact = np.ones(Np)
    for d, a in ((0, a0), (1, a1)):
        exact = exact * (np.exp(1j * np.outer(pts[d], kfull)) @ a).real
    terms = np.exp(1j * np.outer(pts[2], np.arange(H, dtype=float))) * a2h
    exact = exact * (terms[:, 0].real + 2.0 * np.sum(terms[:, 1:].real, axis=1))
    assert rel_err(v, exact) < 1e-5


def test_real_plan_io_types():
    """Real plans take real values in type 1 and a complex spectrum of the
    halved shape in type 2; the other way round raises."""
    rng = np.random.default_rng(72)
    plan = tnufft.set_points(
        tnufft.PlanNUFFT(np.float32, (8, 10, 12), m=3, sigma=2.0, device="cpu"),
        rng.uniform(0, 7, (3, 20)).astype(np.float32))
    assert plan.spectral_shape == (8, 10, 7)
    assert plan.shape_over[-1] % 2 == 0 and plan.spectral_shape_over[-1] == plan.shape_over[-1] // 2 + 1
    assert plan.complex_dtype == torch.complex64 and plan.is_real
    with pytest.raises(TypeError, match="dtype"):
        tnufft.exec_type1(plan, np.zeros(20, np.complex64))
    with pytest.raises(TypeError, match="dtype"):
        tnufft.exec_type2(plan, np.zeros((8, 10, 7), np.float32))
    with pytest.raises(ValueError, match="shape"):
        tnufft.exec_type2(plan, np.zeros((8, 10, 12), np.complex64))
    u = tnufft.exec_type1(plan, np.ones(20, np.float32))
    assert u.shape == (8, 10, 7) and u.dtype == torch.complex64
    assert tnufft.exec_type2(plan, u).dtype == torch.float32
