"""The port's staged timer and plan repr on the CPU, against the JAX
package's (tests/test_geometry.py:107-146): the stage labels, staged and
unstaged results equal, the repr's lines, and the timer on ``set_points``.
"""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.utils.timer import Timer as JaxTimer
from torch_port_utils import random_complex, random_points

torch.set_num_threads(1)

T1 = ["exec_type1/(1) spreading", "exec_type1/(2) forward FFT",
      "exec_type1/(3) deconvolve + truncate"]
T2 = ["exec_type2/(1) deconvolve + pad", "exec_type2/(2) backward FFT",
      "exec_type2/(3) interpolation"]
DIRECT = ["exec_type1/(1) direct NUDFT", "exec_type2/(1) direct NUDFT",
          *(f"exec_type{t}/(1) direct NUDFT/{part}" for t in (1, 2)
            for part in ("phase factors", "product"))]
CALLBACK = ["exec_type1/(0) nonuniform callback", "exec_type2/(4) nonuniform callback"]
METHODS = ["reference", "blocked", "direct"]
#: ``set_points``' parts on each path (no ``sort_points``).
SET_POINTS = {
    "blocked": ["set_points/(1) cell split", "set_points/(2) bin sort",
                "set_points/(3) sorted copies", "set_points/(4) window taps",
                "set_points/(5) transform groups"],
    "reference": ["set_points/(1) fold", "set_points/(5) transform groups"],
    "direct": ["set_points/(1) fold"],
}


def _callbacks(np_):
    w = torch.linspace(0.5, 1.5, np_, dtype=torch.float64)
    return tnufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple(x * w[n] for x in vs),
        uniform=lambda ws, idx: tuple(x * (1.0 + idx[0]) for x in ws),
    )


def _run(plan, pts, v, u, callbacks=None):
    plan = tnufft.set_points(plan, pts)
    return (tnufft.exec_type1(plan, v, callbacks=callbacks),
            tnufft.exec_type2(plan, u, callbacks=callbacks))


@pytest.mark.parametrize("with_callbacks", [False, True], ids=["plain", "callbacks"])
@pytest.mark.parametrize("method", METHODS)
def test_timer_records_stages(method, with_callbacks):
    rng = np.random.default_rng(5)
    t = tnufft.Timer(synchronise=True)
    plan = tnufft.PlanNUFFT(np.complex128, (32, 32), m=4, sigma=2.0, spread_method=method,
                            device="cpu", timer=t)
    pts = random_points(rng, 2, 100, np.complex128)
    cb = _callbacks(100) if with_callbacks else None
    _run(plan, pts, random_complex(rng, np.complex128, 100),
         random_complex(rng, np.complex128, (32, 32)), cb)
    stages = DIRECT if method == "direct" else T1 + T2
    if with_callbacks and method != "direct":
        stages = stages + CALLBACK
    assert set(t.times) == {"set_points", "exec_type1", "exec_type2", *SET_POINTS[method],
                            *stages}
    assert all(t.counts[label] == 1 for label in t.times)
    # each section's children, one level down, take no more than it
    for top in t.times:
        inner = sum(v for k, v in t.times.items() if k.rsplit("/", 1)[0] == top and k != top)
        assert inner <= t.times[top]
    assert "timer attached (synchronise=True)" in repr(tnufft.set_points(plan, pts))
    assert t.counts["set_points"] == 2
    t.reset()
    assert not t.times and not t.counts


@pytest.mark.parametrize("with_callbacks", [False, True], ids=["plain", "callbacks"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.complex128, np.float32])
def test_timer_matches_untimed_results(dtype, method, with_callbacks):
    """The staged path runs the same functions in the same order as the
    unstaged one: equal tensors."""
    rng = np.random.default_rng(6)
    shape = (32, 24)
    pts = random_points(rng, 2, 200, dtype)
    v = random_complex(rng, dtype, 200) if np.dtype(dtype).kind == "c" else \
        rng.standard_normal(200).astype(dtype)
    base = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=2.0, spread_method=method, device="cpu")
    u = random_complex(rng, np.result_type(dtype, np.complex64), base.spectral_shape)
    cb = _callbacks(200) if with_callbacks else None
    timed = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=2.0, spread_method=method,
                             device="cpu", timer=tnufft.Timer())
    u0, v0 = _run(base, pts, v, u, cb)
    u1, v1 = _run(timed, pts, v, u, cb)
    assert torch.equal(u0, u1) and torch.equal(v0, v1)


def test_timed_port_matches_jax_timed():
    """A timed port plan against the JAX package's timed plan (its staged
    path) on the same inputs."""
    rng = np.random.default_rng(7)
    pts = random_points(rng, 2, 200, np.complex128)
    v = random_complex(rng, np.complex128, 200)
    tp = tnufft.set_points(tnufft.PlanNUFFT(np.complex128, (32, 24), m=4, sigma=2.0,
                                            device="cpu", timer=tnufft.Timer()), pts)
    jp = jnufft.set_points(jnufft.PlanNUFFT(np.complex128, (32, 24), m=4, sigma=2.0,
                                            timer=JaxTimer()), pts)
    u = tnufft.exec_type1(tp, v).numpy()
    ju = np.asarray(jnufft.exec_type1(jp, v))
    assert np.linalg.norm(u - ju) / np.linalg.norm(ju) <= 1e-10
    # The JAX package times set_points on its blocked plans only, and no
    # part of it.
    assert set(tp.timer.times) == set(jp.timer.times) | {"set_points", *SET_POINTS["reference"]}


def test_timer_repr_format_matches_jax():
    ours, theirs = tnufft.Timer(), JaxTimer()
    for tm in (ours, theirs):
        for label, s, n in (("exec_type1", 0.0125, 2), ("exec_type1/(1) spreading", 0.01, 2),
                            ("set_points", 0.5, 1)):
            tm.times[label] += s
            tm.counts[label] += n
    assert repr(ours) == repr(theirs)
    assert repr(ours).splitlines()[1].lstrip().startswith("set_points")


def test_timer_sync_on_cpu_returns_value():
    t = tnufft.Timer(synchronise=True)
    x = torch.ones(3)
    assert t.sync(x) is x and t.sync((x, [x])) == (x, [x])
    plan = tnufft.PlanNUFFT(np.complex64, (16,), device="cpu")
    assert t.sync(plan) is plan


@pytest.mark.parametrize(
    "dtype,shape,method,fftshift",
    [(np.complex128, (16, 12), "reference", False),
     (np.complex64, (16, 12, 16), "blocked", True),
     (np.float64, (40,), "direct", False)],
    ids=str,
)
def test_plan_repr_lines(dtype, shape, method, fftshift):
    """The repr's lines are the JAX package's (the reference's Base.show)
    but for the header's backend, the device line and the blocked plans'
    block count; no TPU line (batch, FFT engine, padding waste)."""
    rng = np.random.default_rng(8)
    kw = dict(m=4, sigma=1.5, fftshift=fftshift)
    tp = tnufft.PlanNUFFT(dtype, shape, spread_method=method, device="cpu", **kw)
    jp = jnufft.PlanNUFFT(dtype, shape, spread_method="reference", **kw)
    lines, jlines = repr(tp).splitlines(), repr(jp).splitlines()
    name = np.dtype(dtype).name
    assert lines[0] == f"{len(shape)}-dimensional PlanNUFFT (PyTorch) with input type {name}:"
    assert jlines[0] == f"{len(shape)}-dimensional PlanNUFFT (TPU) with input type {name}:"
    assert lines[1:7] == jlines[1:7]
    assert lines[7].startswith(f"  - spreading method: {method}")
    assert lines[8] == jlines[8] == "  - points set: no"
    assert lines[9] == "  - device: cpu"
    if method == "blocked":
        nblocks = int(np.prod([n // b for n, b in zip(tp.shape_over, tp.block_dims)]))
        assert lines[7].endswith(f", block dims {tp.block_dims}")
        assert lines[10] == f"  - blocked geometry: {nblocks} blocks"
    else:
        assert len(lines) == 10
    pts = random_points(rng, len(shape), 50, dtype)
    assert "  - points set: 50" in repr(tnufft.set_points(tp, pts)).splitlines()
    text = repr(tnufft.set_points(tp, pts))
    assert all(w not in text for w in ("batch", "FFT engine", "padding waste", "tensor("))
