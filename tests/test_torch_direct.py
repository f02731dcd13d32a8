"""The port's direct NUDFT (``ops/direct.py``) on the CPU, mirroring
tests/test_direct.py: against the exact float64 sums for c2c plans (2e-6
for 32-bit plans, 1e-12 for 64-bit ones), against the port's windowed
reference path (m = 8, sigma = 2) and the JAX package's direct path for
the r2c/c2r conventions; callbacks, ``sort_points`` refused, the MAC model
and ``np_hint``'s choice.  N = 8192 in 1D is held to the exact sums, where
the JAX package's float32 phase reduction errs 9.8e-4 (ROADMAP F1).
Also the path's ``phase factors`` and ``product`` sections (Timer and
profiler spans, outputs bit-equal with and without a timer) and its
``DIRECT_CHUNKS`` counter.
"""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops import direct as jdirect
from nonuniformffts_tpu_torch.ops import direct
from nonuniformffts_tpu_torch.plan import auto_spread_method
from nonuniformffts_tpu_torch.utils.timer import SPAN_PREFIX
from nufft_test_utils import direct_type1, direct_type2, direct_type2_real
from torch_port_utils import random_complex, random_points

torch.set_num_threads(1)

TOL = {np.complex64: 2e-6, np.complex128: 1e-12, np.float32: 2e-6, np.float64: 1e-12}


def _max_rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _plan(dtype, shape, pts, **kw):
    return tnufft.set_points(
        tnufft.PlanNUFFT(dtype, shape, spread_method="direct", device="cpu", **kw), pts)


CASES = [
    ((64,), 1, False),
    ((32, 24), 1, False),
    ((16, 12, 20), 1, False),
    ((16, 12, 20), 2, False),
    ((16, 12, 20), 1, True),  # fftshift
]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape,C,fftshift", CASES, ids=str)
def test_direct_c2c_vs_exact(shape, C, fftshift, dtype):
    rng = np.random.default_rng(len(shape) + C)
    D = len(shape)
    pts = random_points(rng, D, 60, dtype)
    v = random_complex(rng, dtype, (C, 60))
    plan = _plan(dtype, shape, pts, ntransforms=C, fftshift=fftshift)
    u = tnufft.exec_type1(plan, v if C > 1 else v[0]).numpy().reshape((C,) + shape)
    v2 = tnufft.exec_type2(plan, u if C > 1 else u[0]).numpy().reshape(C, 60)
    assert u.dtype == v2.dtype == np.dtype(dtype)
    kv = [k.numpy() for k in plan.kvec]
    for c in range(C):
        assert _max_rel(u[c], direct_type1(pts, v[c].astype(np.complex128), kv)) < TOL[dtype]
        assert _max_rel(v2[c], direct_type2(pts, u[c].astype(np.complex128), kv)) < TOL[dtype]


@pytest.mark.parametrize("N", [256, 8192])
def test_direct_phase_precision_large_k(N):
    """k x reaches N pi rad; float64 phases reduced mod 2pi keep the
    complex64 result at the contraction's floor.  At N = 8192 the JAX
    package's float32 split-product reduction errs 9.8e-4 on its float32
    path (ROADMAP F1; this suite runs JAX with x64, where it does not)."""
    rng = np.random.default_rng(N)
    pts = random_points(rng, 1, 40, np.complex64)
    v = random_complex(rng, np.complex64, 40)
    plan = _plan(np.complex64, (N,), pts)
    u = tnufft.exec_type1(plan, v).numpy()
    exact = direct_type1(pts, v.astype(np.complex128), [plan.kvec[0].numpy()])
    assert _max_rel(u, exact) < 2e-6
    uh = random_complex(rng, np.complex64, N)
    v2 = tnufft.exec_type2(plan, uh).numpy()
    assert _max_rel(v2, direct_type2(pts, uh.astype(np.complex128), [plan.kvec[0].numpy()])) < 2e-6


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(24,), (24, 18), (12, 10, 14)], ids=str)
def test_direct_r2c_conventions(shape, dtype):
    """The halved-axis layout of type 1 and the doubling of type 2 against
    the port's windowed reference path (m = 8, sigma = 2), the JAX
    package's direct path (float32) and, for 64-bit plans, the exact sums."""
    rng = np.random.default_rng(sum(shape))
    D = len(shape)
    pts = random_points(rng, D, 80, dtype)
    v = rng.standard_normal(80).astype(dtype)
    plan = _plan(dtype, shape, pts)
    ref = tnufft.set_points(tnufft.PlanNUFFT(dtype, shape, m=8, sigma=2.0,
                                             spread_method="reference", device="cpu"), pts)
    u_d, u_r = tnufft.exec_type1(plan, v).numpy(), tnufft.exec_type1(ref, v).numpy()
    assert u_d.shape == u_r.shape == plan.spectral_shape
    assert _max_rel(u_d, u_r) < 2e-5
    uh = random_complex(rng, np.result_type(dtype, np.complex64), plan.spectral_shape)
    v_d, v_r = tnufft.exec_type2(plan, uh).numpy(), tnufft.exec_type2(ref, uh).numpy()
    assert v_d.dtype == np.dtype(dtype)
    assert _max_rel(v_d, v_r) < 2e-5
    if dtype == np.float32:
        jp = jnufft.set_points(jnufft.PlanNUFFT(dtype, shape, spread_method="direct"), pts)
        assert _max_rel(u_d, np.asarray(jnufft.exec_type1(jp, v))) < 2e-5
        assert _max_rel(v_d, np.asarray(jnufft.exec_type2(jp, uh))) < 2e-5
    else:
        kv = [k.numpy() for k in plan.kvec]
        assert _max_rel(u_d, direct_type1(pts, v.astype(np.complex128), kv)) < 1e-12
        assert _max_rel(v_d, direct_type2_real(pts, uh, kv, shape[-1])) < 1e-12


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_direct_callbacks(dtype):
    """Type 1: nonuniform callback, sums, uniform callback; type 2: uniform
    callback on the spectrum as given (no deconvolution scaling exists on
    this path), sums, nonuniform callback."""
    rng = np.random.default_rng(9)
    shape = (16, 12)
    pts = random_points(rng, 2, 50, dtype)
    v = random_complex(rng, dtype, 50)
    uh = random_complex(rng, dtype, shape)
    plan = _plan(dtype, shape, pts)
    w = rng.uniform(0.5, 1.5, 50)
    w_t = torch.as_tensor(w)
    g = 1.0 + np.arange(shape[0])[:, None] + 2.0 * np.arange(shape[1])[None, :]
    cb = tnufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple(x * w_t[n] for x in vs),
        uniform=lambda ws, idx: tuple(x * (1.0 + idx[0] + 2.0 * idx[1]) for x in ws),
    )
    tol = 10 * np.finfo(np.dtype(dtype).type(0).real.dtype).eps
    u_cb = tnufft.exec_type1(plan, v, cb).numpy()
    u_man = tnufft.exec_type1(plan, (v * w).astype(dtype)).numpy() * g
    assert _max_rel(u_cb, u_man) < tol
    v_cb = tnufft.exec_type2(plan, uh, cb).numpy()
    v_man = tnufft.exec_type2(plan, (uh * g).astype(dtype)).numpy() * w
    assert _max_rel(v_cb, v_man) < tol


def test_direct_rejects_sort_points():
    with pytest.raises(ValueError, match="sort_points"):
        tnufft.PlanNUFFT(np.complex64, (16, 16), spread_method="direct", sort_points=True,
                         device="cpu")


def test_unknown_spread_method_rejected():
    with pytest.raises(ValueError, match="spread_method"):
        tnufft.PlanNUFFT(np.complex64, (16, 16), spread_method="magic", device="cpu")


def test_direct_mac_model_matches_jax():
    """The MAC model is the JAX package's, and its crossover at 256^3 sits
    where JAX's test puts it (near Np ~ 3,900 at c = 1)."""
    spec, over = (256, 256, 256), (384, 384, 384)
    for np_ in (1, 1678, 16777):
        assert direct.direct_macs(np_, spec) == jdirect.direct_macs(np_, spec)
    assert direct.blocked_dft_macs(over) == jdirect.blocked_dft_macs(over)
    assert direct.direct_macs(1678, spec) < direct.blocked_dft_macs(over)
    assert direct.direct_macs(16777, spec) > direct.blocked_dft_macs(over)


@pytest.mark.parametrize("rdt", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("shape,crossover", [((256, 256, 256), (656, 1377)),
                                             ((4096, 4096), (346, 1006)),
                                             ((1 << 20,), (3.77, 3.75))], ids=str)
def test_np_hint_picks_direct_only_on_cuda(shape, crossover, rdt):
    """``spread_method='auto'``: on CUDA 'direct' below the crossover
    measured at these shapes (``chip_probe.py --direct``, complex64 /
    complex128 on an H100), which ``DIRECT_MAC_RATIO`` encodes, and
    'blocked' above it or without ``np_hint``; on the CPU always
    'reference'."""
    over = tuple(3 * n // 2 for n in shape)
    measured = crossover[rdt == torch.float64]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    below, above = int(0.85 * measured), int(1.15 * measured) + 1
    if below >= 1:
        assert auto_spread_method(cuda, below, shape, over, rdt) == "direct"
    assert auto_spread_method(cuda, above, shape, over, rdt) == "blocked"
    assert auto_spread_method(cuda, None, shape, over, rdt) == "blocked"
    for hint in (None, 1, above):
        assert auto_spread_method(cpu, hint, shape, over, rdt) == "reference"
    assert tnufft.PlanNUFFT(np.complex64, (16, 16), np_hint=1,
                            device="cpu").spread_method == "reference"


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
@pytest.mark.parametrize("shape", [(40,), (12, 10), (8, 6, 10)], ids=str)
def test_direct_point_chunks(shape, dtype, monkeypatch):
    """Chunks of points under a small ``FACTOR_BYTES`` give the result of
    one chunk, C = 2, type 1 accumulated and type 2 written chunk by chunk."""
    rng = np.random.default_rng(10)
    pts = random_points(rng, len(shape), 101, dtype)
    real = np.dtype(dtype).kind == "f"
    v = rng.standard_normal((2, 101)) if real else random_complex(rng, dtype, (2, 101))
    plan = _plan(dtype, shape, pts, ntransforms=2)
    uh = random_complex(rng, np.complex128, (2,) + plan.spectral_shape)
    u1, v1 = tnufft.exec_type1(plan, v), tnufft.exec_type2(plan, uh)
    ntail = int(np.prod(plan.spectral_shape[1:]))
    monkeypatch.setattr(direct, "FACTOR_BYTES", 16 * 7 * (ntail + 2 * plan.spectral_shape[0]))
    assert len(direct._chunks(plan, 2)) == 15
    u2, v2 = tnufft.exec_type1(plan, v), tnufft.exec_type2(plan, uh)
    assert _max_rel(u2.numpy(), u1.numpy()) < 1e-14
    assert _max_rel(v2.numpy(), v1.numpy()) < 1e-14


def test_direct_points_fold_in_float64():
    """A direct plan keeps its points folded in float64, also for 32-bit
    plans, and points shifted by multiples of 2pi give the same sums."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 2 * np.pi, (2, 30))
    v = random_complex(rng, np.complex64, 30)
    p0 = _plan(np.complex64, (32, 24), pts)
    p1 = _plan(np.complex64, (32, 24), pts + 2 * np.pi * rng.integers(-3, 4, pts.shape))
    assert p0.points.dtype == torch.float64
    assert _max_rel(tnufft.exec_type1(p1, v).numpy(), tnufft.exec_type1(p0, v).numpy()) < 1e-6


STAGE = "(1) direct NUDFT"
PARTS = ("phase factors", "product")


def _chunked_plan(monkeypatch, timer=None, shape=(12, 10, 14), C=2, np_=101):
    """A 3D complex128 direct plan with its points set, ``FACTOR_BYTES``
    cut so that its points run in 4 chunks; its values and spectrum."""
    rng = np.random.default_rng(12)
    ntail = int(np.prod(shape[1:]))
    monkeypatch.setattr(direct, "FACTOR_BYTES", 16 * 30 * (ntail + C * shape[0]))
    plan = _plan(np.complex128, shape, random_points(rng, 3, np_, np.complex128),
                 ntransforms=C, timer=timer)
    assert len(direct._chunks(plan, C)) == 4
    return (plan, torch.from_numpy(random_complex(rng, np.complex128, (C, np_))),
            torch.from_numpy(random_complex(rng, np.complex128, (C,) + shape)))


def test_direct_sections_nest_in_the_stage(monkeypatch):
    """With a Timer, each exec's ``(1) direct NUDFT`` holds a ``phase
    factors`` and a ``product`` section a chunk, which together take no
    more than the stage."""
    timer = tnufft.Timer(synchronise=True)
    plan, v, u = _chunked_plan(monkeypatch, timer)
    tnufft.exec_type1(plan, v)
    tnufft.exec_type2(plan, u)
    for ex in ("exec_type1", "exec_type2"):
        stage = f"{ex}/{STAGE}"
        parts = [f"{stage}/{p}" for p in PARTS]
        assert all(timer.counts[p] == 4 for p in parts) and timer.counts[stage] == 1
        assert sum(timer.times[p] for p in parts) <= timer.times[stage]


def test_direct_spans_without_a_timer(monkeypatch):
    """With no timer, a profiler's trace carries the sections as spans
    ``nufft:exec_type{1,2}/(1) direct NUDFT/phase factors`` and ``/product``,
    one a chunk."""
    plan, v, u = _chunked_plan(monkeypatch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tnufft.exec_type1(plan, v)
        tnufft.exec_type2(plan, u)
    names = [e.name for e in prof.events()]
    for ex in ("exec_type1", "exec_type2"):
        for p in PARTS:
            assert names.count(f"{SPAN_PREFIX}{ex}/{STAGE}/{p}") == 4


@pytest.mark.parametrize("shape", [(40,), (12, 10), (12, 10, 14)], ids=str)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float64])
def test_direct_outputs_bit_equal_with_a_timer(shape, dtype):
    rng = np.random.default_rng(13)
    pts = random_points(rng, len(shape), 70, dtype)
    real = np.dtype(dtype).kind == "f"
    v = rng.standard_normal((2, 70)).astype(dtype) if real else random_complex(rng, dtype, (2, 70))
    plain = _plan(dtype, shape, pts, ntransforms=2)
    timed = _plan(dtype, shape, pts, ntransforms=2, timer=tnufft.Timer(synchronise=True))
    uh = random_complex(rng, np.result_type(dtype, np.complex64), (2,) + plain.spectral_shape)
    assert torch.equal(tnufft.exec_type1(plain, v), tnufft.exec_type1(timed, v))
    assert torch.equal(tnufft.exec_type2(plain, uh), tnufft.exec_type2(timed, uh))
    assert f"exec_type2/{STAGE}/product" in timed.timer.times


def test_direct_chunks_counts_each_exec(monkeypatch):
    """``DIRECT_CHUNKS`` adds ``len(_chunks(plan, C))`` an exec, by type,
    and ``reset_chunk_counts`` zeros it."""
    plan, v, u = _chunked_plan(monkeypatch)
    direct.reset_chunk_counts()
    assert direct.DIRECT_CHUNKS == {"exec_type1": 0, "exec_type2": 0}
    tnufft.exec_type1(plan, v)
    tnufft.exec_type1(plan, v)
    tnufft.exec_type2(plan, u)
    assert direct.DIRECT_CHUNKS == {"exec_type1": 8, "exec_type2": 4}
    direct.reset_chunk_counts()
    assert not any(direct.DIRECT_CHUNKS.values())


def test_direct_chunks_at_the_benchmark_cell():
    """1,678 complex128 points on 256^3 (the protocol's rho = 1e-4 row) run
    in 2 chunks a transform, 1,020 + 658 points: the tail factor of 65,536
    modes and 256 first-dim rows at 16 bytes each fit 1,020 points into
    ``FACTOR_BYTES``.  Worked out from the chunk arithmetic; no sums run."""
    rng = np.random.default_rng(14)
    plan = _plan(np.complex128, (256, 256, 256), rng.uniform(0, 2 * np.pi, (3, 1678)))
    assert direct.FACTOR_BYTES // (16 * (256 * 256 + 256)) == 1020
    assert direct._chunks(plan, 1) == [(0, 1020), (1020, 1678)]
