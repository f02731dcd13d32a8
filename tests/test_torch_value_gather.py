"""The spread's ``value gather`` section and the 2D interpolation's
``INTERP2D_ROWS`` counter (``ops/kernels/blocked.py``) on the CPU: the
counter's keys, its reset and its rule against ``common.INTERP2D_ROWS_M``;
the plain spread a CPU plan runs opens no ``value gather``, in a Timer or
as a profiler span, and launches nothing.  Their card side is in
``tests/test_torch_cuda.py``.  The file imports no JAX."""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.ops.kernels import blocked
from nonuniformffts_tpu_torch.ops.kernels.common import (
    INTERP2D_ROWS_M,
    KERNEL_M_RANGE,
    VALUE_TYPES,
    entry_point_name,
)
from nonuniformffts_tpu_torch.utils.timer import SPAN_PREFIX

torch.set_num_threads(1)

DTYPES = [np.complex64, np.complex128, np.float32, np.float64]
SHAPES = {1: (64,), 2: (32, 40), 3: (16, 14, 20)}
GATHER = "exec_type1/(1) spreading/value gather"
NP = 200


def _plan(dtype, ndim, m=4, timer=None, C=1, seed=1):
    """A blocked CPU plan on ``SHAPES[ndim]`` with its points set, and its
    (C, Np) values."""
    rng = np.random.default_rng(seed)
    real = np.dtype(dtype).type(0).real.dtype
    pts = torch.from_numpy(rng.uniform(0, 2 * np.pi, (ndim, NP)).astype(real))
    plan = tnufft.PlanNUFFT(dtype, SHAPES[ndim], m=m, sigma=1.5, ntransforms=C,
                            spread_method="blocked", device="cpu", timer=timer)
    v = rng.standard_normal((C, NP))
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal((C, NP))
    return tnufft.set_points(plan, pts), torch.from_numpy(v.astype(dtype))


def test_counter_has_one_key_a_2d_interpolation_entry_point():
    want = {entry_point_name("interp", 2, dt) for dt in VALUE_TYPES}
    assert set(blocked.INTERP2D_ROWS) == want and len(want) == 4
    assert set(blocked.INTERP2D_ROWS) <= set(blocked.LAUNCHES)


def test_reset_zeros_the_counter():
    for name in blocked.INTERP2D_ROWS:
        blocked.INTERP2D_ROWS[name] += 3
    blocked.SPREAD3D_SHARED[entry_point_name("spread", 3, torch.complex64)] += 2
    blocked.reset_launch_counts()
    assert not any(blocked.INTERP2D_ROWS.values())
    assert not any(blocked.SPREAD3D_SHARED.values())


@pytest.mark.parametrize("m", list(KERNEL_M_RANGE))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_rows_rule_is_the_kernels(dtype, m):
    """A 2D launch of C transforms counts C where ``INTERP2D_ROWS_M`` (the
    kernel's ``rows_mask``) gives the value type and M the whole-chunk rows,
    else 0; a 1D or 3D plan counts 0."""
    _, scalar_bytes, ncomp = VALUE_TYPES[torch.from_numpy(np.zeros(1, dtype)).dtype]
    rows = m in INTERP2D_ROWS_M[scalar_bytes, ncomp]
    for ndim in (1, 2, 3):
        plan = tnufft.PlanNUFFT(dtype, SHAPES[ndim], m=m, sigma=1.5, ntransforms=3,
                                spread_method="blocked", device="cpu")
        assert blocked.interp2d_rows_served(plan, 3) == (3 if rows and ndim == 2 else 0)


def test_complex128_at_m4_takes_the_rows_design():
    """The 2D deployment's plan (complex128, M = 4) is counted."""
    plan = tnufft.PlanNUFFT(np.complex128, (4096, 4096), m=4, sigma=1.5,
                            spread_method="blocked", device="cpu")
    assert blocked.interp2d_rows_served(plan, 1) == 1


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_plain_spread_opens_no_value_gather(dtype, ndim):
    """On CPU tensors the spread runs its plain version: no ``value
    gather`` in the Timer nor among the profiler's spans, no launch, no
    count; the grid is the one an untimed plan gives."""
    timer = tnufft.Timer(synchronise=True)
    plan, v = _plan(dtype, ndim, timer=timer, C=2, seed=ndim)
    blocked.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = tnufft.exec_type1(plan, v)
    plan_u, _ = _plan(dtype, ndim, C=2, seed=ndim)
    assert torch.equal(got, tnufft.exec_type1(plan_u, v))
    assert "exec_type1/(1) spreading" in timer.times and GATHER not in timer.times
    assert not any(label.endswith("value gather") for label in timer.times)
    assert not any(e.name.startswith(SPAN_PREFIX) and e.name.endswith("value gather")
                   for e in prof.events())
    grid = blocked.spread_blocked(plan, v)
    assert grid.shape == (2,) + tuple(plan.shape_over)
    assert not any(blocked.LAUNCHES.values()) and not any(blocked.INTERP2D_ROWS.values())


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_plain_2d_interpolation_counts_nothing(dtype):
    """The plain interpolation a CPU plan runs adds nothing to the counter,
    even where the kernel would take the rows design."""
    plan, _ = _plan(dtype, 2, C=2)
    blocked.reset_launch_counts()
    grid = torch.zeros((2,) + tuple(plan.shape_over), dtype=plan.dtype)
    out = blocked.interpolate_blocked(plan, grid)
    assert out.shape == (2, NP)
    assert not any(blocked.INTERP2D_ROWS.values())
