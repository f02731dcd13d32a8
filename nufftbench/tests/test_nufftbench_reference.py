"""The plain reference against brute-force NumPy sums at tiny sizes, and
its window against the formulas it interpolates."""

import math

import numpy as np
import pytest
import torch

from nufftbench.references.nufft import Reference, Window, window_exact

# m = 4, sigma = 1.5 gives about 1e-6 (NonuniformFFTs.jl's accuracy model)
TOL = 4e-6
CASES = [((16, 16, 16), "complex128"), ((12, 10, 16), "complex128"), ((16, 20), "complex128"),
         ((32,), "complex128"), ((16, 16, 16), "float64"), ((12, 10, 16), "float64"),
         ((16, 20), "float64"), ((32,), "float64")]


def _config(shape, dtype):
    return {"shape": list(shape), "dtype": dtype, "m": 4, "sigma": 1.5,
            "kernel": "BackwardsKaiserBesselKernel", "kernel_evalmode": "FastApproximation"}


def _exact(shape, real, x, v, u):
    """Type 1 and type 2 as their definitions' sums (float64 NumPy); on a
    real plan the stored k > 0 of the last axis count twice and type 2
    keeps real parts."""
    D = len(shape)
    ks = [np.fft.fftfreq(n, 1.0 / n) for n in shape]
    if real:
        ks[-1] = np.arange(shape[-1] // 2 + 1, dtype=np.float64)
    K = np.stack(np.meshgrid(*ks, indexing="ij"), -1).reshape(-1, D)
    ph = K @ x
    t1 = (np.exp(-1j * ph) @ v).reshape([len(k) for k in ks])
    c = np.where(K[:, -1] > 0, 2.0, 1.0) if real else np.ones(len(K))
    t2 = (c * u.reshape(-1)) @ np.exp(1j * ph)
    return t1, (t2.real if real else t2)


@pytest.mark.parametrize("seed", [11, 2**31 + 5])
@pytest.mark.parametrize("shape,dtype", CASES)
def test_reference_against_exact_sums(shape, dtype, seed):
    real = dtype == "float64"
    gen = torch.Generator().manual_seed(seed)
    D, npts = len(shape), 300
    # unfolded coordinates: the reference folds them itself
    x = torch.rand((D, npts), generator=gen, dtype=torch.float64) * 6 * math.pi - 2 * math.pi
    v = torch.randn((1, npts), generator=gen, dtype=torch.float64 if real else torch.complex128)
    spec = shape[:-1] + (shape[-1] // 2 + 1,) if real else shape
    u = torch.randn((1,) + spec, generator=gen, dtype=torch.complex128)
    ref = Reference(_config(shape, dtype), "cpu")
    t1, t2 = ref.type1(x, v)[0].numpy(), ref.type2(x, u)[0].numpy()
    e1, e2 = _exact(shape, real, x.numpy(), v[0].numpy(), u[0].numpy())
    assert t1.shape == e1.shape and t2.shape == e2.shape
    assert np.linalg.norm(t1 - e1) / np.linalg.norm(e1) < TOL
    assert np.linalg.norm(t2 - e2) / np.linalg.norm(e2) < TOL


def test_fast_window_interpolates_the_formula():
    win = Window(4, 384, 1.5)
    t = np.arange(8.0)
    X = np.linspace(0, 1, 1001)[:-1]
    fast = win.taps(torch.as_tensor(X)).numpy()
    exact = window_exact(win.beta, (3.0 - t + X[:, None]) / 4)
    gap = np.abs(fast - exact).max() / np.abs(exact).max()
    assert 0 < gap < 1e-6
    # at the Chebyshev nodes of each piece the two agree to rounding
    X = (np.cos(np.pi * (np.arange(8) + 0.5) / 8) + 1) / 2
    at = win.taps(torch.as_tensor(X)).numpy()
    want = window_exact(win.beta, (3.0 - t + X[:, None]) / 4)
    assert np.abs(at - want).max() / np.abs(want).max() < 1e-13


def test_other_windows_are_refused():
    with pytest.raises(ValueError):
        Reference(dict(_config((8, 8), "complex128"), kernel="KaiserBesselKernel"), "cpu")
