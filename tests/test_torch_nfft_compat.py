"""The port's NFFT-convention adapter (``nonuniformffts_tpu_torch/
nfft_compat.py``) against the JAX package's (``nonuniformffts_tpu/
nfft_compat.py``) and against exact NFFT-convention sums, mirroring
``tests/test_nfft_compat.py``.  Points lie in [-1/2, 1/2), frequencies run
-N/2 .. N/2 - 1; forward f_j = sum_k fhat[k] e^{-2 pi i k.x_j}, adjoint
fhat[k] = sum_j f_j e^{+2 pi i k.x_j}.  The port's plans here run the
blocked method on the CPU (the plain versions of the CUDA kernels)."""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.nfft_compat import accuracy_params as j_accuracy_params
from nonuniformffts_tpu_torch.nfft_compat import WINDOWS, accuracy_params
from test_torch_window_paths import error_budget
from torch_port_utils import rel_err

torch.set_num_threads(1)

CPU = dict(device="cpu", spread_method="blocked")


def _direct(x, N, sign):
    """Per-dim (Np, N_d) factors e^{sign 2 pi i k x} over increasing k."""
    return [np.exp(sign * 2j * np.pi * x[d][:, None]
                   * np.arange(-(n // 2), (n + 1) // 2)[None, :])
            for d, n in enumerate(N)]


def nfft_forward_exact(x, fhat):
    mats = _direct(x, fhat.shape, -1.0)
    if len(mats) == 1:
        return mats[0] @ fhat
    return np.einsum("ja,jb,ab->j", mats[0], mats[1], fhat)


def nfft_adjoint_exact(x, f, N):
    mats = _direct(x, N, 1.0)
    if len(mats) == 1:
        return mats[0].T @ f
    return np.einsum("ja,jb,j->ab", mats[0], mats[1], f)


def _inputs(seed, N, np_=120):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (len(N), np_))
    fhat = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    f = rng.standard_normal(np_) + 1j * rng.standard_normal(np_)
    return x, fhat, f


def test_accuracy_params_match_jax():
    """Both packages choose the same (m, sigma) for every request."""
    for reltol in np.logspace(-15, -0.5, 60):
        for f32 in (False, True):
            for precision in (None, "double"):
                assert (accuracy_params(reltol, f32=f32, precision=precision)
                        == j_accuracy_params(reltol, f32=f32, precision=precision))
    assert accuracy_params(1e-9) == (6, 2.0)
    with pytest.raises(ValueError):
        accuracy_params(0.0)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_forward_and_adjoint_match_jax(window):
    """complex128, N = (16, 12), reltol 1e-9 (m = 6, sigma = 2): forward and
    adjoint against the JAX adapter on the CPU to 1e-12."""
    N = (16, 12)
    x, fhat, f = _inputs(1, N)
    tp = tnufft.plan_nfft(x, N, window=window, **CPU)
    jp = jnufft.plan_nfft(x, N, window=window)
    assert (tp.plan.m, tp.plan.sigma) == (jp.plan.m, jp.plan.sigma) == (6, 2.0)
    assert type(tp.plan.kernel).__name__ == type(jp.plan.kernel).__name__
    got_f, got_a = tp.forward(fhat), tp.adjoint(f)
    assert got_f.dtype == torch.complex128 and tuple(got_a.shape) == N
    assert rel_err(got_f.numpy(), np.asarray(jp.forward(fhat))) <= 1e-12
    assert rel_err(got_a.numpy(), np.asarray(jp.adjoint(f))) <= 1e-12


@pytest.mark.parametrize("window", ["kaiser_bessel", "gauss"])
def test_complex64_matches_jax(window):
    """complex64 plans (reltol 1e-5, m = 3) against the JAX adapter, 1e-5."""
    N = (24,)
    x, fhat, f = _inputs(2, N)
    kw = dict(reltol=1e-5, window=window, dtype=np.complex64)
    tp = tnufft.plan_nfft(x, N, **kw, **CPU)
    jp = jnufft.plan_nfft(x, N, **kw)
    assert tp.plan.m == jp.plan.m
    assert rel_err(tp.forward(fhat).numpy(), np.asarray(jp.forward(fhat))) <= 1e-5
    assert rel_err(tp.adjoint(f).numpy(), np.asarray(jp.adjoint(f))) <= 1e-5


@pytest.mark.parametrize("N", [(64,), (32, 24)], ids=str)
@pytest.mark.parametrize("window", ["kaiser_bessel", "gauss", "spline"])
def test_matches_exact_nfft_sums(window, N):
    """Forward and adjoint at the default reltol 1e-9 against exact
    NFFT-convention sums: within 10 x reltol for Kaiser-Bessel, within D
    times the window's 1D budget at m = 6, sigma = 2 for the others."""
    x, fhat, f = _inputs(3, N, np_=300)
    p = tnufft.plan_nfft(x, N, window=window, **CPU)
    kind = type(p.plan.kernel).__name__
    tol = 1e-8 if window == "kaiser_bessel" else len(N) * error_budget(kind, 6)
    assert rel_err(p.forward(fhat).numpy(), nfft_forward_exact(x, fhat)) <= tol
    assert rel_err(p.adjoint(f).numpy(), nfft_adjoint_exact(x, f, N)) <= tol


def test_operators_sizes_and_nodes():
    """``@``, ``.H``, ``.H.H``, sizes and a functional ``with_nodes``; the
    adjoint identity <A fhat, f> = <fhat, A^H f> holds to rounding."""
    N = (32, 16)
    x, fhat, f = _inputs(4, N, np_=100)
    p = tnufft.plan_nfft(x, N, **CPU)
    assert p.size_in == N and p.size_out == (100,) and p.num_nodes == 100
    assert p.H.H is p
    lhs = np.vdot((p @ fhat).numpy(), f)
    rhs = np.vdot(fhat, (p.H @ f).numpy())
    assert abs(lhs - rhs) / abs(lhs) < 1e-12
    x2 = np.random.default_rng(5).uniform(-0.5, 0.5, (2, 70))
    p2 = p.with_nodes(x2)
    assert p2.size_out == (70,) and p.size_out == (100,)
    assert rel_err((p2 @ fhat).numpy(), nfft_forward_exact(x2, fhat)) <= 1e-8
    assert "NFFTPlan" in repr(p)


def test_one_shot_helpers_and_tensor_inputs():
    N = (32,)
    x, fhat, _ = _inputs(6, N, np_=64)
    f = tnufft.nfft(x, fhat, reltol=1e-8, **CPU)
    assert rel_err(f.numpy(), nfft_forward_exact(x, fhat)) < 1e-7
    fh = tnufft.nfft_adjoint(torch.from_numpy(x), f, N, reltol=1e-8, **CPU)
    assert tuple(fh.shape) == N
    assert rel_err(fh.numpy(), nfft_adjoint_exact(x, f.numpy(), N)) < 1e-7


def test_errors_and_default_device():
    """An unknown window and a real dtype raise; without ``device`` a plan
    means the card, which this host lacks."""
    x = np.random.default_rng(7).uniform(-0.5, 0.5, (1, 16))
    for w in sorted(WINDOWS):
        assert tnufft.plan_nfft(x, (16,), reltol=1e-4, window=w, **CPU).size_in == (16,)
    with pytest.raises(ValueError, match="unknown window"):
        tnufft.plan_nfft(x, (16,), window="hann", **CPU)
    for dtype in (np.float64, torch.float32):
        with pytest.raises(TypeError, match="complex"):
            tnufft.NFFTPlan(x, (16,), dtype=dtype, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnufft.plan_nfft(x, (16,))
