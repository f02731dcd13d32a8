"""The plain PyTorch versions of the two hand-written kernels against the
JAX package: spreading against ``spread_reference``, interpolation against
``interpolate_reference``, and the blocked wrappers, which on CPU tensors
run those plain versions from the bin-sorted point state."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu.ops.interpolation import interpolate_reference as j_interp
from nonuniformffts_tpu.ops.pallas.common import coefficient_stack as j_coefs
from nonuniformffts_tpu.ops.spreading import spread_reference as j_spread
from nonuniformffts_tpu_torch.ops.interpolation import interpolate_reference as t_interp
from nonuniformffts_tpu_torch.ops.kernels import blocked
from nonuniformffts_tpu_torch.ops.spreading import spread_reference as t_spread
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)

TOL = {np.complex64: 1e-5, np.complex128: 1e-12}
CASES = [
    ((20,), 1, None),
    ((16, 12), 2, 97),
    ((12, 16, 10), 1, None),
    ((12, 16, 10), 2, 64),
]


def _plans(shape, dtype, C):
    kw = dict(m=4, sigma=1.5, ntransforms=C)
    return (tnufft.PlanNUFFT(dtype, shape, device="cpu", **kw),
            jnufft.PlanNUFFT(dtype, shape, **kw))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape,C,chunk", CASES, ids=str)
def test_plain_spread_matches_jax(shape, C, chunk, dtype):
    rng = np.random.default_rng(1)
    tp, jp = _plans(shape, dtype, C)
    pts = random_points(rng, len(shape), 300, dtype)
    v = random_complex(rng, dtype, (C, 300))
    got = t_spread(tp.kernel_data, tp.evalmode, tp.shape_over,
                   torch.from_numpy(pts), torch.from_numpy(v), chunk_size=chunk)
    want = j_spread(jp.kernel_data, jp.evalmode, jp.shape_over,
                    jnp.asarray(pts), jnp.asarray(v), chunk_size=chunk)
    assert got.shape == (C,) + tp.shape_over and got.dtype == tp.dtype
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape,C,chunk", CASES, ids=str)
def test_plain_interp_matches_jax(shape, C, chunk, dtype):
    rng = np.random.default_rng(2)
    tp, jp = _plans(shape, dtype, C)
    pts = random_points(rng, len(shape), 300, dtype)
    g = random_complex(rng, dtype, (C,) + tp.shape_over)
    got = t_interp(tp.kernel_data, tp.evalmode, torch.from_numpy(g),
                   torch.from_numpy(pts), tp.normfactor, chunk_size=chunk)
    want = j_interp(jp.kernel_data, jp.evalmode, jnp.asarray(g),
                    jnp.asarray(pts), jp.normfactor, chunk_size=chunk)
    assert got.shape == (C, 300)
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_blocked_wrappers_on_cpu_run_plain_versions(dtype):
    """On CPU tensors the K1/K2 wrappers run the plain versions from the
    sorted state; they match JAX's reference path and launch nothing."""
    rng = np.random.default_rng(3)
    shape = (12, 16, 10)
    tp = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=2,
                          spread_method="blocked", device="cpu", chunk_size=101)
    _, jp = _plans(shape, dtype, 2)
    pts = random_points(rng, 3, 400, dtype)
    v = random_complex(rng, dtype, (2, 400))
    g = random_complex(rng, dtype, (2,) + tp.shape_over)
    tp = tnufft.set_points(tp, pts)
    blocked.reset_launch_counts()
    grid = blocked.spread_blocked(tp, torch.from_numpy(v))
    vals = blocked.interpolate_blocked(tp, torch.from_numpy(g))
    assert len(blocked.LAUNCHES) == 38 and not any(blocked.LAUNCHES.values())
    want_g = j_spread(jp.kernel_data, jp.evalmode, jp.shape_over,
                      jnp.asarray(pts), jnp.asarray(v))
    want_v = j_interp(jp.kernel_data, jp.evalmode, jnp.asarray(g),
                      jnp.asarray(pts), jp.normfactor)
    assert rel_err(grid.numpy(), np.asarray(want_g)) <= TOL[dtype]
    assert rel_err(vals.numpy(), np.asarray(want_v)) <= TOL[dtype]


def test_wrappers_refuse_other_devices():
    tp = tnufft.PlanNUFFT(np.complex64, (8, 8, 8), m=2, sigma=2.0,
                          spread_method="blocked", device="cpu")
    tp = tnufft.set_points(tp, np.zeros((3, 4), np.float32))
    meta = dict(device="meta", dtype=torch.complex64)
    with pytest.raises(ValueError, match="no spread kernel"):
        blocked.spread_blocked(tp, torch.empty((1, 4), **meta))
    with pytest.raises(ValueError, match="no interpolation kernel"):
        blocked.interpolate_blocked(tp, torch.empty((1, 16, 16, 16), **meta))


def test_coefficient_stack_matches_jax():
    tp = tnufft.PlanNUFFT(np.complex64, (16, 12, 20), m=5, sigma=1.5, device="cpu")
    jp = jnufft.PlanNUFFT(np.complex64, (16, 12, 20), m=5, sigma=1.5)
    want = np.asarray(j_coefs(jp.kernel_data))
    assert tp.coefs.shape == want.shape == (3, 10, 9)
    assert tp.coefs.dtype == torch.float32 and tp.coefs.is_contiguous()
    np.testing.assert_array_equal(tp.coefs.numpy(), want)


def test_kernel_support_checks():
    """What the CUDA kernels do not take is refused, not run elsewhere:
    the Direct mode and m = 10 are taken, and a 3D or 2D block of any size
    (both spreads keep their sums in registers, the 3D one walking its
    points once per pass of 16 warps, the 2D one once per unit, and the 2D
    one's shared memory does not depend on the block); m = 11 raises naming
    the JAX package's documented maximum, and a 1D block whose start table
    exceeds the card's shared memory raises."""
    tp = tnufft.PlanNUFFT(np.complex64, (16, 16, 16), m=4, sigma=1.5,
                          spread_method="blocked", device="cpu")
    blocked.check_kernel_support(tp)
    blocked.check_kernel_support(dataclasses.replace(tp, evalmode=tnufft.Direct()))
    blocked.check_kernel_support(tnufft.PlanNUFFT(
        np.complex64, (16, 16, 16), m=10, sigma=2.0, spread_method="blocked", device="cpu"))
    blocked.check_kernel_support(dataclasses.replace(tp, block_dims=(24, 24, 24)))
    tp2 = tnufft.PlanNUFFT(np.complex64, (256, 256), m=4, sigma=1.5,
                           spread_method="blocked", device="cpu")
    blocked.check_kernel_support(dataclasses.replace(tp2, block_dims=(128, 128)))
    tp1 = tnufft.PlanNUFFT(np.complex64, (65536,), m=4, sigma=2.0,
                           spread_method="blocked", device="cpu")
    bad = [
        (dataclasses.replace(tp, shape=(16,) * 4), NotImplementedError, "4D"),
        (dataclasses.replace(tp, dtype=torch.bfloat16), NotImplementedError, "bfloat16"),
        (dataclasses.replace(tp, m=11), NotImplementedError, "m in 2..10.*documented maximum"),
        (dataclasses.replace(tp1, block_dims=(65536,)), ValueError, "shared memory"),
    ]
    for plan, exc, match in bad:
        with pytest.raises(exc, match=match):
            blocked.check_kernel_support(plan)


def test_m_above_10_names_no_queue():
    """m = 11 is refused at the JAX package's documented maximum, not sent
    to a work queue."""
    plan = tnufft.PlanNUFFT(np.complex128, (16, 16), m=11, sigma=2.0,
                            spread_method="blocked", device="cpu")
    with pytest.raises(NotImplementedError) as err:
        blocked.check_kernel_support(plan)
    msg = str(err.value)
    assert "got m=11" in msg and "documented maximum" in msg and "ROADMAP" not in msg
