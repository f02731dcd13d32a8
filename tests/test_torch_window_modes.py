"""Every window in both evaluation modes, the port against the JAX package.

- ``window_weights``: the plain twin of the CUDA kernels' tap evaluators
  (``ops/kernels/common.py``) against the JAX kernels' own
  (``nonuniformffts_tpu/ops/pallas/common.py:window_weights``, plain jnp),
  for the four windows, both modes, m = 2..10, float32 and float64.
- The twin against the plain path's ``eval_window_frac``, which the
  kernels' plain versions run: the gap of the fast Gaussian.
- 1D blocked plans of every window and mode against the JAX blocked plan,
  which runs the yz-form kernels (interpret mode).  2D, 3D and the exact
  sums are in ``test_torch_window_paths.py``.
- ``plan_data_from_numpy`` from JAX Gaussian, B-spline and KB-Direct plans.
- ``kernel_precision='fxp'``, a TPU mode the port accepts and ignores.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops import windows as jwin
from nonuniformffts_tpu.ops.pallas.common import window_weights as j_window_weights
from nonuniformffts_tpu_torch.interop import plan_data_from_numpy
from nonuniformffts_tpu_torch.ops import windows as twin
from nonuniformffts_tpu_torch.ops.kernels.common import window_weights as t_window_weights
from nufft_test_utils import random_values
from torch_port_utils import (
    EVALMODE_NAMES,
    KERNEL_NAMES,
    evalmode_pair,
    kernel_pair,
    random_complex,
    real_dtype,
    rel_err,
)

torch.set_num_threads(1)

# Largest tap difference over the largest tap.  float64: the two compute the
# same operations in the same order (I0 by torch.special.i0 against JAX's
# Chebyshev besseli0_poly); 5.7e-15 measured.  float32: the direct (B)KB
# taps round beta * s, and e^(beta s - beta) then carries beta 2^-24
# relative (beta ~ 47 at m = 10); 3.4e-6 measured (KB Direct, m = 8).
TAP_TOL = {np.float64: 1e-13, np.float32: 5e-6}
# Blocked plans against JAX: float32 on both sides summed in another order;
# float64 on both sides.
TOL = {4: 1e-5, 8: 1e-12}
WINDOWS = [(k, e) for k in KERNEL_NAMES for e in EVALMODE_NAMES]


def _fractions(dtype):
    X = np.random.default_rng(21).uniform(0.0, 1.0, 257)
    X[0], X[1] = 0.0, np.nextafter(1.0, 0.0)
    return X.astype(dtype)[None, :]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [2, 4, 6, 8, 10])
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_window_weights_match_jax(window, m, dtype):
    """(2M, P) taps from in-cell fractions, 257 of them including 0 and
    nextafter(1, 0); row t is the weight of node c - M + 1 + t."""
    (tk, jk), (te, je) = kernel_pair(window[0]), evalmode_pair(window[1])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tkd = twin.make_kernel_data(tk, m, 64, 2.0, tdt, "cpu")
    jkd = jwin.make_kernel_data(jk, m, 64, 2.0, dtype)
    X = _fractions(dtype)
    cs = None if tkd.cs_poly is None else tkd.cs_poly.T
    jcs = jnp.zeros((2 * m, 1), dtype) if jkd.cs_poly is None else jnp.asarray(jkd.cs_poly).T
    got = t_window_weights(tkd, te, torch.from_numpy(X), cs)
    want = np.asarray(j_window_weights(jkd, je, jnp.asarray(X), jcs))
    assert got.shape == want.shape == (2 * m, 257) and got.dtype == tdt
    assert np.isfinite(want).all()
    err = np.abs(got.numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= TAP_TOL[dtype], err


@pytest.mark.parametrize("m", [4, 10])
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_window_weights_match_plain_path(window, m):
    """The kernels' taps against ``eval_window_frac`` in float64: the same
    function, except that the fast Gaussian of the plain path uses fast
    Gaussian gridding (products of exps) where the kernels take one exp
    per node; that gap measures 1.2e-16 (relative L2) at m = 4 and 10."""
    tk, te = getattr(tnufft, window[0])(), getattr(tnufft, window[1])()
    kd = twin.make_kernel_data(tk, m, 96, 2.0, torch.float64, "cpu")
    X = torch.from_numpy(_fractions(np.float64))
    cs = None if kd.cs_poly is None else kd.cs_poly.T
    got = t_window_weights(kd, te, X, cs)
    want = twin.eval_window_frac(kd, te, X[0]).T
    assert rel_err(got.numpy(), want.numpy()) <= 1e-14


@pytest.mark.parametrize("window", [w for w in WINDOWS if not (
    w[0].startswith(("Kaiser", "Backwards")) and w[1] == "FastApproximation")],
    ids=lambda w: f"{w[0]}-{w[1]}")
def test_window_weights_blocked_matches_jax(window):
    """The window-weights kernel's plain version (K3, what a CPU plan runs):
    the (D, 2M, Np) taps of the sorted points of a 3D float64 plan, against
    JAX's window_weights on each dimension's sorted fractions, 1e-13."""
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    (tk, jk), (te, je) = kernel_pair(window[0]), evalmode_pair(window[1])
    shape, m = (8, 10, 12), 5
    tp = tnufft.PlanNUFFT(np.float64, shape, m=m, sigma=2.0, kernel=tk, kernel_evalmode=te,
                          spread_method="blocked", device="cpu")
    jp = jnufft.PlanNUFFT(np.float64, shape, m=m, sigma=2.0, kernel=jk, kernel_evalmode=je)
    pts = np.random.default_rng(22).uniform(0, 2 * np.pi, (3, 200))
    tp = tnufft.set_points(tp, pts)
    got = blocked.window_weights_blocked(tp).numpy()
    assert got.shape == (3, 2 * m, 200)
    for d, jkd in enumerate(jp.kernel_data):
        X = jnp.asarray(tp.fracs_sorted[d].numpy()[None, :])
        want = np.asarray(j_window_weights(jkd, je, X, jnp.zeros((2 * m, 1))))
        assert np.abs(got[d] - want).max() <= 1e-13 * np.abs(want).max()


def _jax_port_plans(dtype, shape, window, m, sigma, C=1):
    (tk, jk), (te, je) = kernel_pair(window[0]), evalmode_pair(window[1])
    kw = dict(m=m, sigma=sigma, ntransforms=C, spread_method="blocked")
    tp = tnufft.PlanNUFFT(dtype, shape, kernel=tk, kernel_evalmode=te, device="cpu", **kw)
    jp = jnufft.PlanNUFFT(dtype, shape, kernel=jk, kernel_evalmode=je, interpret=True, **kw)
    assert jp.kernel_form == "yz" and tp.shape_over == jp.shape_over
    return tp, jp


def _inputs(rng, dtype, shape, spectral_shape, np_=300):
    real = real_dtype(dtype)
    pts = rng.uniform(-2 * np.pi, 4 * np.pi, (len(shape), np_)).astype(real)
    pts[:, :4] = np.nextafter(real.type(2 * np.pi), real.type(0))
    v = random_complex(rng, np.complex128, np_)
    v = (v if np.dtype(dtype).kind == "c" else v.real).astype(dtype)
    cdt = np.complex64 if real == np.float32 else np.complex128
    return pts, v, random_complex(rng, cdt, spectral_shape)


def _run(pkg, plan, pts, v, u):
    plan = pkg.set_points(plan, pts)
    out = (pkg.exec_type1(plan, v), pkg.exec_type2(plan, u))
    return tuple(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in out)


def check_against_jax(dtype, shape, window, m, sigma, seed):
    tp, jp = _jax_port_plans(dtype, shape, window, m, sigma)
    pts, v, u = _inputs(np.random.default_rng(seed), dtype, shape, tp.spectral_shape)
    u1, v2 = _run(tnufft, tp, pts, v, u)
    ju1, jv2 = _run(jnufft, jp, pts, v, u)
    tol = TOL[real_dtype(dtype).itemsize]
    assert u1.shape == ju1.shape and v2.shape == jv2.shape and v2.dtype == np.dtype(dtype)
    assert rel_err(u1, ju1) <= tol
    assert rel_err(v2, jv2) <= tol


DTYPES = [np.complex64, np.complex128, np.float64]


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_blocked_1d_m4_matches_jax(window):
    """1D, N = 40, m = 4, sigma = 1.5, every window and mode; the dtype
    turns with the window so that each kind meets each dtype."""
    i = WINDOWS.index(window)
    check_against_jax(DTYPES[i % 3], (40,), window, 4, 1.5, seed=30 + i)


@pytest.mark.parametrize("window,dtype", [
    (("KaiserBesselKernel", "Direct"), np.complex128),
    (("BackwardsKaiserBesselKernel", "Direct"), np.float64),
    (("GaussianKernel", "FastApproximation"), np.complex64),
    (("BSplineKernel", "Direct"), np.complex128),
], ids=str)
def test_blocked_1d_m10_matches_jax(window, dtype):
    """1D, N = 40, m = 10 (2M = 20 taps on a grid of 80), sigma = 2: each
    window evaluator once at the largest half-support.  (One interpret-mode
    JAX run takes 4-13 s here, so not every pair.)"""
    check_against_jax(dtype, (40,), window, 10, 2.0, seed=40)


def _jax_window_fields(jp, with_coefs: bool):
    kds = jp.kernel_data
    out = dict(
        kind=kds[0].kind, m=kds[0].m,
        phihat_inv=[np.asarray(p) for p in jp.phihat_inv],
        index_ranges=jp.index_ranges, shape_over=jp.shape_over,
    )
    if kds[0].kind in ("kb", "bkb"):
        out.update(beta=[kd.beta for kd in kds], peak=[kd.peak for kd in kds])
        if with_coefs:
            out["cs_poly"] = [np.asarray(kd.cs_poly) for kd in kds]
    if kds[0].kind == "gaussian":
        out.update(tau=[kd.tau for kd in kds], cs_gauss=[np.asarray(kd.cs_gauss) for kd in kds])
    return out


@pytest.mark.parametrize("window", [("GaussianKernel", "FastApproximation"),
                                    ("BSplineKernel", "Direct"),
                                    ("KaiserBesselKernel", "Direct")], ids=str)
def test_interop_from_jax_window_plan(window):
    """A JAX plan's window state (Gaussian: tau and cs_gauss; B-spline: the
    shape; KB Direct: beta and peak, no coefficients) carried into the port
    gives the port's own transforms to 1e-12 in complex128."""
    shape = (16, 12)
    (tk, jk), (te, je) = kernel_pair(window[0]), evalmode_pair(window[1])
    kw = dict(m=5, sigma=2.0)
    jp = jnufft.PlanNUFFT(np.complex128, shape, kernel=jk, kernel_evalmode=je, **kw)
    tp = tnufft.PlanNUFFT(np.complex128, shape, kernel=tk, kernel_evalmode=te,
                          spread_method="blocked", device="cpu", **kw)
    data = plan_data_from_numpy(**_jax_window_fields(jp, with_coefs=False),
                                dtype=torch.float64, device="cpu")
    assert data["coefs"] is None
    carried = dataclasses.replace(tp, **data)
    assert carried.window == tp.window
    pts, v, u = _inputs(np.random.default_rng(50), np.complex128, shape, tp.spectral_shape)
    own = _run(tnufft, tp, pts, v, u)
    for a, b in zip(_run(tnufft, carried, pts, v, u), own):
        assert rel_err(a, b) <= 1e-12


def test_kernel_precision_fxp_meets_the_jax_oracle_budget():
    """``kernel_precision='fxp'`` selects int8 three-limb MXU contractions
    in the JAX kernels (``blocked.py:_fxp_dot``), a TPU workaround: the CUDA
    kernels contract on no tensor core and sum in double, so the port
    accepts the value and changes nothing.  On the JAX fxp test's inputs
    (tests/test_blocked.py:409-438: 16^3, m = 4, sigma = 1.5, 2,000
    points, complex64, float64 oracle) the port meets that test's budget
    (max-normalised error < 2e-5) and is no worse than JAX's fxp result."""
    rng = np.random.default_rng(42)  # the JAX test's rng fixture
    shape, np_ = (16, 16, 16), 2000
    pts = rng.uniform(0, 2 * np.pi, (3, np_)).astype(np.float64).astype(np.float32)
    v = random_values(rng, np.complex128, (1, np_))[0].astype(np.complex64)
    ref = jnufft.set_points(jnufft.PlanNUFFT(np.complex128, shape, m=4, sigma=1.5),
                            pts.astype(np.float64))
    u_ref = np.asarray(jnufft.exec_type1(ref, v.astype(np.complex128)))
    v2_ref = np.asarray(jnufft.exec_type2(ref, u_ref))
    kw = dict(m=4, sigma=1.5, spread_method="blocked", kernel_precision="fxp")
    jp = jnufft.set_points(jnufft.PlanNUFFT(np.complex64, shape, interpret=True,
                                            fft_method="matmul", np_hint=np_, **kw), pts)
    tp = tnufft.set_points(tnufft.PlanNUFFT(np.complex64, shape, device="cpu", **kw), pts)

    def errs(pkg, plan):
        u = np.asarray(pkg.exec_type1(plan, v))
        v2 = np.asarray(pkg.exec_type2(plan, u_ref.astype(np.complex64)))
        return (np.abs(u - u_ref).max() / np.abs(u_ref).max(),
                np.abs(v2 - v2_ref).max() / np.abs(v2_ref).max())

    port, jax_fxp = errs(tnufft, tp), errs(jnufft, jp)
    for e_port, e_jax in zip(port, jax_fxp):
        assert e_port < 2e-5
        assert e_port <= e_jax
