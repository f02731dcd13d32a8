"""Window math and plan-time numerics of the PyTorch port against the JAX
package: kernel data, Fourier coefficients, deconvolution factors, the
high-accuracy cell split, window evaluation and the interop round trip."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops import windows as jwin
from nonuniformffts_tpu.utils.besseli0 import besseli0 as j_i0
from nonuniformffts_tpu.utils.misc import next_fast_len as j_nfl
from nonuniformffts_tpu_torch.interop import plan_data_from_numpy
from nonuniformffts_tpu_torch.ops import windows as twin
from nonuniformffts_tpu_torch.utils.besseli0 import besseli0 as t_i0
from nonuniformffts_tpu_torch.utils.misc import next_fast_len as t_nfl
from torch_port_utils import (
    EVALMODE_NAMES,
    KERNEL_NAMES,
    evalmode_pair,
    jax_kernel_data_np,
    kernel_pair,
    port_kernel_data_np,
    random_complex,
    random_points,
    rel_err,
)

torch.set_num_threads(1)

TIGHT = 1e-14


def _close(a, b, tol=TIGHT):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("name", KERNEL_NAMES)
@pytest.mark.parametrize("m,sigma", [(4, 1.5), (6, 2.0)])
def test_kernel_data_matches_jax(name, m, sigma):
    tk, jk = kernel_pair(name)
    n = 96
    tkd = port_kernel_data_np(twin.make_kernel_data(tk, m, n, sigma, torch.float64, "cpu"))
    jkd = jax_kernel_data_np(jwin.make_kernel_data(jk, m, n, sigma, np.float64))
    for key in ("kind", "m", "n"):
        assert tkd[key] == jkd[key]
    for key in ("beta", "tau", "w", "dx", "peak"):
        assert _close(tkd[key], jkd[key]), key
    for key in ("cs_poly", "cs_gauss"):
        assert (tkd[key] is None) == (jkd[key] is None), key
        if tkd[key] is not None:
            assert tkd[key].shape == jkd[key].shape
            assert _close(tkd[key], jkd[key]), key
    k = np.fft.fftfreq(64, 1.0 / 64)
    tkd_obj = twin.make_kernel_data(tk, m, n, sigma, torch.float64, "cpu")
    jkd_obj = jwin.make_kernel_data(jk, m, n, sigma, np.float64)
    assert _close(twin.fourier_coefficients_np(tkd_obj, k),
                  jwin.fourier_coefficients_np(jkd_obj, k))


@pytest.mark.parametrize("fftshift", [False, True])
def test_plan_deconvolution_data_matches_jax(fftshift):
    shape = (16, 12, 20)
    kw = dict(m=4, sigma=1.5, fftshift=fftshift)
    tp = tnufft.PlanNUFFT(np.complex128, shape, device="cpu", **kw)
    jp = jnufft.PlanNUFFT(np.complex128, shape, **kw)
    assert tp.shape_over == jp.shape_over
    assert tp.index_ranges == tuple(jp.index_ranges)
    assert tp.normfactor == pytest.approx(jp.normfactor, rel=TIGHT)
    assert tp.sigma == pytest.approx(jp.sigma, rel=TIGHT)
    for a, b in zip(tp.phihat_inv, jp.phihat_inv):
        assert _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [24, 96, 384, 385])
def test_point_to_cell_split_bitwise(dtype, n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-3 * np.pi, 5 * np.pi, 20_000)
    edge = [0.0, -0.0, 2 * np.pi, np.nextafter(2 * np.pi, 0), -1e-9, 1e-30]
    x = np.concatenate([x, edge, np.float32(2 * np.pi) + np.zeros(1)]).astype(dtype)
    cj, Xj = jwin.point_to_cell_split(jnp.asarray(x), n)
    ct, Xt = twin.point_to_cell_split(torch.from_numpy(x), n)
    cj, Xj = np.asarray(cj), np.asarray(Xj)
    assert Xt.numpy().dtype == Xj.dtype == np.dtype(dtype)
    # The port splits r = x * n / 2pi in float64 for both dtypes and rounds
    # only the fraction to the point's dtype, bit for bit.
    r = x.astype(np.float64) * (np.float64(n) / np.float64(2 * np.pi))
    i = np.floor(r)
    np.testing.assert_array_equal(ct.numpy(), np.mod(i, n).astype(np.int32))
    np.testing.assert_array_equal(Xt.numpy().view(np.uint8),
                                  (r - i).astype(dtype).view(np.uint8))
    if dtype == np.float64:  # the JAX package's float64 split is the same
        np.testing.assert_array_equal(ct.numpy(), cj)
        np.testing.assert_array_equal(Xt.numpy().view(np.uint8), Xj.view(np.uint8))
    else:
        # The JAX package's float32 double-single product is within its
        # n * 2^-36 cells of the float64 split (plus the fraction's rounding).
        d = np.mod(ct.numpy() + Xt.numpy().astype(np.float64) - cj - Xj + n / 2, n) - n / 2
        assert np.abs(d).max() <= n * 2.0**-34 + 2.0**-23
    assert ct.min() >= 0 and ct.max() < n


@pytest.mark.parametrize("name", KERNEL_NAMES)
@pytest.mark.parametrize("mode", EVALMODE_NAMES)
def test_eval_window_frac_matches_jax(name, mode):
    tk, jk = kernel_pair(name)
    te, je = evalmode_pair(mode)
    X = np.random.default_rng(3).uniform(0, 1, 500)
    tkd = twin.make_kernel_data(tk, 5, 64, 2.0, torch.float64, "cpu")
    jkd = jwin.make_kernel_data(jk, 5, 64, 2.0, np.float64)
    got = twin.eval_window_frac(tkd, te, torch.from_numpy(X)).numpy()
    want = np.asarray(jwin.eval_window_frac(jkd, je, jnp.asarray(X)))
    assert got.shape == want.shape == (500, 10)
    assert np.abs(got - want).max() <= 1e-13


def test_besseli0_and_next_fast_len_match_jax():
    x = np.linspace(0.0, 60.0, 2001)
    got = t_i0(torch.from_numpy(x)).numpy()
    assert rel_err(got, np.asarray(j_i0(jnp.asarray(x)))) <= 1e-14
    assert [t_nfl(n) for n in range(1, 800)] == [j_nfl(n) for n in range(1, 800)]


def _jax_plan_numpy(jp):
    return dict(
        kind=jp.kernel_data[0].kind,
        cs_poly=[np.asarray(kd.cs_poly) for kd in jp.kernel_data],
        beta=[kd.beta for kd in jp.kernel_data],
        peak=[kd.peak for kd in jp.kernel_data],
        phihat_inv=[np.asarray(p) for p in jp.phihat_inv],
        index_ranges=jp.index_ranges,
        shape_over=jp.shape_over,
    )


def test_interop_round_trip():
    shape = (16, 16, 16)
    kw = dict(m=4, sigma=1.5)
    jp = jnufft.PlanNUFFT(np.complex128, shape, **kw)
    tp = tnufft.PlanNUFFT(np.complex128, shape, device="cpu", spread_method="blocked", **kw)
    data = plan_data_from_numpy(**_jax_plan_numpy(jp), dtype=torch.float64, device="cpu")

    # The port's own plan builds the same numbers.
    assert data["shape_over"] == tp.shape_over
    assert data["index_ranges"] == tp.index_ranges
    assert _close(data["coefs"].numpy(), tp.coefs.numpy())
    for a, b in zip(data["phihat_inv"], tp.phihat_inv):
        assert _close(a.numpy(), b.numpy())
    for a, b in zip(data["kernel_data"], tp.kernel_data):
        pa, pb = port_kernel_data_np(a), port_kernel_data_np(b)
        for key in ("kind", "m", "n"):
            assert pa[key] == pb[key]
        for key in ("beta", "w", "dx", "peak", "cs_poly"):
            assert _close(pa[key], pb[key]), key

    # The port runs on exactly the JAX package's coefficients.
    tp_j = dataclasses.replace(tp, **data)
    rng = np.random.default_rng(5)
    pts = random_points(rng, 3, 300, np.complex128)
    v = random_complex(rng, np.complex128, 300)
    u_own = tnufft.exec_type1(tnufft.set_points(tp, pts), v).numpy()
    u_jax = tnufft.exec_type1(tnufft.set_points(tp_j, pts), v).numpy()
    assert rel_err(u_jax, u_own) <= 1e-13
