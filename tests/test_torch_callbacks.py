"""User callbacks in the port on the CPU, mirroring tests/test_callbacks.py
(the reference's test/callbacks.jl): a fused callback gives exactly what
applying the same operations by hand around a plain transform gives; the
64-bit plans and the channel API stand in for the JAX package's
double-single case; and the same callback written once in ``jnp`` and once
in ``torch`` gives the JAX package's result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.execution import from_channels, to_channels
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)

SHAPE = (32, 28)
NP = 150
METHODS = ["reference", "blocked"]


def _kgrid(shape):
    k = [np.fft.fftfreq(n, 1.0 / n) for n in shape]
    return k, np.add.outer(k[0] ** 2, k[1] ** 2)


@pytest.fixture(params=METHODS)
def setup(request):
    rng = np.random.default_rng(42)
    pts = random_points(rng, 2, NP, np.complex128)
    v = random_complex(rng, np.complex128, NP)
    weights = rng.uniform(0.5, 1.5, NP)
    plan = tnufft.set_points(
        tnufft.PlanNUFFT(np.complex128, SHAPE, sigma=2.0, spread_method=request.param,
                         device="cpu"), pts)
    return plan, v, weights


def _weight_cb(weights):
    w = torch.as_tensor(weights)
    return tnufft.NUFFTCallbacks(nonuniform=lambda vs, n: tuple(x * w[n] for x in vs))


def test_nonuniform_callback_type1(setup):
    plan, v, weights = setup
    fused = tnufft.exec_type1(plan, v, callbacks=_weight_cb(weights)).numpy()
    manual = tnufft.exec_type1(plan, v * weights).numpy()
    assert rel_err(fused, manual) <= 1e-13


def test_uniform_callback_type1(setup):
    """The uniform callback multiplies each output mode by |k|^2 (the
    example from the reference docs, src/plan.jl:124-143)."""
    plan, v, _ = setup
    (kx, ky), k2 = _kgrid(SHAPE)
    tkx, tky = torch.as_tensor(kx), torch.as_tensor(ky)

    def cb_u(ws, idx):
        i, j = idx
        return tuple(w * (tkx[i] ** 2 + tky[j] ** 2) for w in ws)

    fused = tnufft.exec_type1(plan, v, callbacks=tnufft.NUFFTCallbacks(uniform=cb_u)).numpy()
    plain = tnufft.exec_type1(plan, v).numpy()
    np.testing.assert_allclose(fused, plain * k2, rtol=1e-12, atol=1e-12)


def test_callbacks_type2(setup):
    plan, _, weights = setup
    rng = np.random.default_rng(3)
    u = random_complex(rng, np.complex128, SHAPE)
    scale = 2.5
    w = torch.as_tensor(weights)
    cb = tnufft.NUFFTCallbacks(
        uniform=lambda ws, idx: tuple(x * scale for x in ws),
        nonuniform=lambda vs, n: tuple(x * w[n] for x in vs),
    )
    fused = tnufft.exec_type2(plan, u, callbacks=cb).numpy()
    plain = tnufft.exec_type2(plan, u * scale).numpy()
    np.testing.assert_allclose(fused, plain * weights, rtol=1e-12)


def test_callbacks_multiple_transforms(setup):
    """Callbacks see the full tuple of components (src/plan.jl:80-97): C = 2,
    both callbacks on both types, against the swap done by hand."""
    plan1, _, _ = setup
    rng = np.random.default_rng(4)
    pts = random_points(rng, 2, NP, np.complex128)
    v = random_complex(rng, np.complex128, (2, NP))
    u = random_complex(rng, np.complex128, (2,) + SHAPE)
    plan = tnufft.set_points(tnufft.PlanNUFFT(
        np.complex128, SHAPE, ntransforms=2, sigma=2.0, spread_method=plan1.spread_method,
        device="cpu"), pts)
    swap = tnufft.NUFFTCallbacks(nonuniform=lambda vs, n: (vs[1], vs[0]),
                                 uniform=lambda ws, idx: (ws[1], 2.0 * ws[0]))
    fused1 = tnufft.exec_type1(plan, v, callbacks=swap).numpy()
    plain1 = tnufft.exec_type1(plan, v[::-1].copy()).numpy()
    assert rel_err(fused1, plain1[::-1] * np.array([1.0, 2.0])[:, None, None]) <= 1e-13
    fused2 = tnufft.exec_type2(plan, u, callbacks=swap).numpy()
    plain2 = tnufft.exec_type2(plan, np.stack([u[1], 2.0 * u[0]])).numpy()
    assert rel_err(fused2, plain2[::-1]) <= 1e-13


def test_inputs_never_modified(setup):
    plan, v, weights = setup
    rng = np.random.default_rng(5)
    u = random_complex(rng, np.complex128, SHAPE)
    cb = tnufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple(x * 2.0 for x in vs),
        uniform=lambda ws, idx: tuple(x * (1.0 + idx[0]) for x in ws),
    )
    for x, fn in ((v, tnufft.exec_type1), (u, tnufft.exec_type2)):
        for given in (x.copy(), torch.as_tensor(x.copy())):
            fn(plan, given, callbacks=cb)
            np.testing.assert_array_equal(np.asarray(given), x)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_callbacks_64bit_plans(dtype):
    """Fused callbacks on 64-bit blocked plans equal the same operations
    done by hand (the JAX package's double-single case, whose host-side
    float64 callbacks the port's native float64 replaces).  On a real plan
    the nonuniform callback sees real values."""
    rng = np.random.default_rng(6)
    shape = (24, 20)
    real = np.dtype(dtype).kind == "f"
    pts = random_points(rng, 2, 400, dtype)
    v = rng.standard_normal(400) if real else random_complex(rng, dtype, 400)
    weights = rng.uniform(0.5, 1.5, 400)
    plan = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, m=6, sigma=2.0,
                                              spread_method="blocked", device="cpu"), pts)
    seen = []
    w_t = torch.as_tensor(weights)

    def cb_nu_fn(vs, n):
        seen.append(vs[0].dtype)
        return tuple(x * w_t[n] for x in vs)

    cb_nu = tnufft.NUFFTCallbacks(nonuniform=cb_nu_fn)
    fused = tnufft.exec_type1(plan, v, callbacks=cb_nu).numpy()
    manual = tnufft.exec_type1(plan, v * weights).numpy()
    assert rel_err(fused, manual) <= 1e-13
    assert seen == [plan.dtype]

    kx = np.fft.fftfreq(shape[0], 1.0 / shape[0])
    ky = np.arange(shape[1] // 2 + 1) if real else np.fft.fftfreq(shape[1], 1.0 / shape[1])
    tkx, tky = torch.as_tensor(kx), torch.as_tensor(ky)
    k2g = 1.0 + kx[:, None] ** 2 + ky[None, :] ** 2

    def cb_u_fn(ws, idx):
        i, j = idx
        return tuple(w * (1.0 + tkx[i] ** 2 + tky[j] ** 2) for w in ws)

    cb_u = tnufft.NUFFTCallbacks(uniform=cb_u_fn)
    plain1 = tnufft.exec_type1(plan, v).numpy()
    fused1 = tnufft.exec_type1(plan, v, callbacks=cb_u).numpy()
    np.testing.assert_allclose(fused1, plain1 * k2g, rtol=1e-12, atol=1e-12)
    # Type 2: the uniform callback sees the deconvolution-scaled spectrum
    # (src/NonuniformFFTs.jl:453-480), which commutes with the product.
    fused2 = tnufft.exec_type2(plan, plain1, callbacks=cb_u).numpy()
    manual2 = tnufft.exec_type2(plan, plain1 * k2g).numpy()
    assert rel_err(fused2, manual2) <= 1e-12
    seen.clear()
    fused3 = tnufft.exec_type2(plan, plain1, callbacks=cb_nu).numpy()
    plain3 = tnufft.exec_type2(plan, plain1).numpy()
    assert rel_err(fused3, plain3 * weights) <= 1e-13
    assert seen == [plan.dtype]


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_callbacks_channel_api(dtype):
    """``exec_type{1,2}_channels`` carry the callbacks: their output is the
    complex API's, in channels."""
    rng = np.random.default_rng(7)
    real = np.dtype(dtype).kind == "f"
    pts = random_points(rng, 2, 200, dtype)
    v = rng.standard_normal((2, 200)) if real else random_complex(rng, dtype, (2, 200))
    plan = tnufft.set_points(tnufft.PlanNUFFT(dtype, (16, 12), ntransforms=2,
                                              spread_method="blocked", device="cpu"), pts)
    cb = tnufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: (vs[0] * (1.0 + n), vs[1] - vs[0]),
        uniform=lambda ws, idx: (ws[0] * (idx[0] + 2 * idx[1]), ws[1] + ws[0]),
    )
    u = tnufft.exec_type1(plan, v, callbacks=cb)
    v_ch = torch.as_tensor(v) if real else to_channels(torch.as_tensor(v), 1)
    u_ch = tnufft.exec_type1_channels(plan, v_ch, callbacks=cb)
    assert torch.equal(from_channels(u_ch, 1), u)
    v2 = tnufft.exec_type2(plan, u, callbacks=cb)
    v2_ch = tnufft.exec_type2_channels(plan, u_ch, callbacks=cb)
    assert torch.equal(v2_ch if real else from_channels(v2_ch, 1), v2)


@pytest.mark.parametrize("fftshift", [False, True], ids=["fftw", "fftshift"])
@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_callbacks_match_jax(dtype, fftshift):
    """The same callbacks, once in ``jnp`` and once in ``torch``, on the
    JAX package's reference plan and the port's: the point index ``n`` and
    the grid positions ``idx`` (storage order, also under fftshift) mean
    the same in both.  C = 2."""
    rng = np.random.default_rng(8)
    shape = (16, 20)
    real = np.dtype(dtype).kind == "f"
    pts = random_points(rng, 2, 300, dtype)
    v = rng.standard_normal((2, 300)) if real else random_complex(rng, dtype, (2, 300))
    kw = dict(m=6, sigma=2.0, ntransforms=2, fftshift=fftshift)
    tp = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, device="cpu", **kw), pts)
    jp = jnufft.set_points(jnufft.PlanNUFFT(dtype, shape, spread_method="reference", **kw),
                           pts)
    weights = rng.uniform(0.5, 1.5, 300)
    w_j, w_t = jnp.asarray(weights), torch.as_tensor(weights)

    # ``f64`` makes an index float64: in torch an integer tensor times a
    # Python float is float32 (the default dtype), in JAX with x64 float64.
    def callbacks(w, exp, f64):
        return dict(
            nonuniform=lambda vs, n: (vs[0] * w[n], vs[1] * (1.0 + 0.01 * f64(n)) - vs[0]),
            uniform=lambda ws, idx: (ws[0] * exp(-0.01 * f64(idx[0] ** 2 + idx[1])),
                                     ws[1] + 0.5 * ws[0] * idx[1]),
        )

    tcb = tnufft.NUFFTCallbacks(**callbacks(w_t, torch.exp, lambda x: x.double()))
    jcb = jnufft.NUFFTCallbacks(**callbacks(w_j, jnp.exp, lambda x: x))
    u = tnufft.exec_type1(tp, v, callbacks=tcb).numpy()
    ju = np.asarray(jnufft.exec_type1(jp, v, callbacks=jcb))
    assert rel_err(u, ju) <= 1e-10
    v2 = tnufft.exec_type2(tp, ju, callbacks=tcb).numpy()
    jv2 = np.asarray(jnufft.exec_type2(jp, ju, callbacks=jcb))
    assert rel_err(v2, jv2) <= 1e-10
