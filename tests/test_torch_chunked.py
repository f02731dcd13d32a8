"""The port's points-chunked plans (``chunked.py``) on the CPU, mirroring
tests/test_chunked.py: chunked against the port's unchunked plan on the
same points (3D, r2c, 2D, ragged Np, and 1D, where a grid shared by the
chunks' spreads would lose the interior cells the 1D kernel stores), and
against the JAX package's chunked plan on its reference path; callbacks
with the global point index, and the errors.
"""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)

CASES = [
    ((16, 12, 20), np.complex64, 1, 2, 800),    # divisible
    ((16, 12, 20), np.complex64, 2, 3, 1000),   # ragged (334, 333, 333)
    ((12, 10, 14), np.float32, 1, 3, 500),      # r2c, ragged
    ((32, 24), np.complex64, 1, 4, 600),        # 2D
    ((256,), np.complex64, 1, 3, 301),          # 1D
    ((16, 12, 20), np.complex128, 2, 3, 1000),
    ((12, 10, 14), np.float64, 1, 3, 500),
    ((256,), np.complex128, 1, 3, 301),
]
TOL = {4: 1e-5, 8: 1e-12}
KW = dict(sigma=1.5, m=4)


def _values(rng, dtype, shape):
    if np.dtype(dtype).kind == "c":
        return random_complex(rng, dtype, shape)
    return rng.standard_normal(shape).astype(dtype)


def _inputs(shape, dtype, C, Np, seed=0):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, len(shape), Np, dtype)
    v = _values(rng, dtype, (C, Np))
    return pts, v if C > 1 else v[0]


def _tol(dtype):
    return TOL[np.dtype(dtype).itemsize if np.dtype(dtype).kind == "f"
               else np.dtype(dtype).itemsize // 2]


@pytest.mark.parametrize("method", ["blocked", "reference"])
@pytest.mark.parametrize("shape,dtype,C,K,Np", CASES, ids=str)
def test_chunked_matches_unchunked(shape, dtype, C, K, Np, method):
    pts, v = _inputs(shape, dtype, C, Np)
    kw = dict(KW, ntransforms=C, spread_method=method, device="cpu")
    ref = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, np_hint=Np, **kw), pts)
    u_ref = tnufft.exec_type1(ref, v)
    v2_ref = tnufft.exec_type2(ref, u_ref)

    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=K, np_hint=Np, **kw), pts)
    assert [p.num_points for p in cpl.plans] == [len(c) for c in np.array_split(np.arange(Np), K)]
    assert cpl.num_points_total == Np
    u_chk = tnufft.exec_type1_chunked(cpl, v)
    v2_chk = tnufft.exec_type2_chunked(cpl, u_ref)
    assert u_chk.shape == u_ref.shape and u_chk.dtype == u_ref.dtype
    assert v2_chk.shape == v2_ref.shape and v2_chk.dtype == v2_ref.dtype
    assert rel_err(u_chk.numpy(), u_ref.numpy()) <= _tol(dtype)
    assert rel_err(v2_chk.numpy(), v2_ref.numpy()) <= _tol(dtype)


@pytest.mark.parametrize("shape,dtype,C,K,Np", CASES, ids=str)
def test_chunked_matches_jax_chunked(shape, dtype, C, K, Np):
    """The port's chunked plan against the JAX package's
    ``exec_type{1,2}_chunked`` on ``spread_method='reference'``; 64-bit plans
    to 1e-12 (the JAX reference path is float64 there)."""
    pts, v = _inputs(shape, dtype, C, Np, seed=1)
    kw = dict(KW, ntransforms=C, spread_method="reference")
    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=K, device="cpu", **kw), pts)
    jcpl = jnufft.set_points_chunked(jnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=K, **kw),
                                     pts)
    u = tnufft.exec_type1_chunked(cpl, v).numpy()
    ju = np.asarray(jnufft.exec_type1_chunked(jcpl, v))
    assert rel_err(u, ju) <= _tol(dtype)
    v2 = tnufft.exec_type2_chunked(cpl, ju).numpy()
    jv2 = np.asarray(jnufft.exec_type2_chunked(jcpl, ju))
    assert rel_err(v2, jv2) <= _tol(dtype)


@pytest.mark.parametrize("method", ["blocked", "direct"])
@pytest.mark.parametrize("shape", [(16, 12, 20), (256,)], ids=str)
def test_chunked_callbacks_see_global_index(shape, method):
    """The nonuniform callback runs on the whole value array, so ``n`` is
    the global point index (a per-chunk index would weight the wrong
    points); the uniform one runs once.  Fused chunked equals fused
    unchunked."""
    Np, K = 700, 3
    pts, v = _inputs(shape, np.complex128, 2, Np, seed=2)
    w = torch.as_tensor(np.random.default_rng(3).uniform(0.5, 1.5, Np))
    cb = tnufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: (vs[0] * w[n], vs[1] * w[Np - 1 - n]),
        uniform=lambda ws, idx: (ws[0] * (1.0 + idx[0]), ws[1] - ws[0]),
    )
    kw = dict(KW, ntransforms=2, spread_method=method, device="cpu")
    ref = tnufft.set_points(tnufft.PlanNUFFT(np.complex128, shape, **kw), pts)
    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(np.complex128, shape, nchunks=K, **kw), pts)
    u = tnufft.exec_type1_chunked(cpl, v, callbacks=cb)
    assert rel_err(u.numpy(), tnufft.exec_type1(ref, v, callbacks=cb).numpy()) <= 1e-12
    v2 = tnufft.exec_type2_chunked(cpl, u, callbacks=cb)
    assert rel_err(v2.numpy(), tnufft.exec_type2(ref, u, callbacks=cb).numpy()) <= 1e-12


def test_chunked_requires_set_points():
    cpl = tnufft.ChunkedPlanNUFFT(np.complex64, (16, 12, 20), nchunks=2,
                                  spread_method="blocked", device="cpu")
    with pytest.raises(RuntimeError, match="points not set"):
        tnufft.exec_type1_chunked(cpl, np.zeros(8, np.complex64))
    with pytest.raises(RuntimeError, match="points not set"):
        tnufft.exec_type2_chunked(cpl, np.zeros((16, 12, 20), np.complex64))


def test_chunked_rejects_bad_arguments():
    with pytest.raises(ValueError, match="nchunks"):
        tnufft.ChunkedPlanNUFFT(np.complex64, (16, 16), nchunks=0, device="cpu")
    with pytest.raises(NotImplementedError, match="timers"):
        tnufft.ChunkedPlanNUFFT(np.complex64, (16, 16), nchunks=2, device="cpu",
                                timer=tnufft.Timer())
    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(np.complex64, (16, 16), nchunks=2, device="cpu"),
        random_points(np.random.default_rng(4), 2, 10, np.complex64))
    with pytest.raises(ValueError, match="number of values"):
        tnufft.exec_type1_chunked(cpl, np.zeros(9, np.complex64))


@pytest.mark.parametrize("dtype,precision", [(np.complex64, "double"),
                                             (np.complex128, "double"),
                                             (np.float64, "highest")], ids=str)
def test_chunked_accepts_64bit_and_double(dtype, precision):
    """The JAX package refuses complex64 with ``precision='double'``
    (ROADMAP F3: it counts any 8-byte dtype as double-single); the port
    accepts it and every 64-bit plan, and their results match the
    unchunked plan."""
    shape, Np = (16, 12, 10), 400
    pts, v = _inputs(shape, dtype, 1, Np, seed=5)
    kw = dict(KW, precision=precision, spread_method="blocked", device="cpu")
    cpl = tnufft.set_points_chunked(tnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=3, **kw),
                                    pts)
    ref = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, **kw), pts)
    u = tnufft.exec_type1_chunked(cpl, v)
    assert rel_err(u.numpy(), tnufft.exec_type1(ref, v).numpy()) <= _tol(dtype)
    if dtype == np.complex64:
        with pytest.raises(NotImplementedError, match="extended-precision"):
            jnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=3, precision="double")


def test_chunked_np_hint_divided_by_nchunks(monkeypatch):
    """``np_hint`` is the total count; each chunk's template sees its
    share (rounded up), as in the JAX package."""
    from nonuniformffts_tpu_torch import chunked

    seen = []
    real = chunked.PlanNUFFT

    def spy(*args, **kw):
        seen.append(kw["np_hint"])
        return real(*args, **kw)

    monkeypatch.setattr(chunked, "PlanNUFFT", spy)
    chunked.ChunkedPlanNUFFT(np.complex64, (16,), nchunks=3, np_hint=1000, device="cpu")
    chunked.ChunkedPlanNUFFT(np.complex64, (16,), nchunks=3, device="cpu")
    assert seen == [334, None]
