"""The port's 64-bit path on the CPU: complex128 blocked plans against the
JAX package's double-single pipeline and its float64 reference path, the
interop from a double-single plan, and the Hopper geometry of every value
type.

The JAX double-single plan (``precision='double'``, ``spread_method=
'blocked'``) runs ``_spread_kernel_ds`` / ``_interp_kernel_ds`` in interpret
mode; the port's blocked wrappers run the plain versions of the native-FP64
kernels that replace them (``nufft_spread_3d_f64`` / ``nufft_interp_3d_f64``)
on CPU tensors.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch import blocking
from nonuniformffts_tpu_torch.interop import plan_data_from_numpy
from nonuniformffts_tpu_torch.ops.kernels.common import (
    KERNEL_M_RANGE,
    MAX_SMEM_BYTES,
    VALUE_TYPES,
    spread_smem_bytes,
)
from torch_port_utils import random_complex, rel_err

torch.set_num_threads(1)

# Against the JAX double-single pipeline: its (hi, lo) pairs carry ~48
# bits, the bar of tests/test_ds.py.
TOL_DS = 5e-11
# Against the JAX float64 reference path: both native float64.
TOL_F64 = 1e-10
# Interop: the ds pairs hold ~48 bits of each coefficient.
TOL_INTEROP = 1e-12
SHAPE, M, SIGMA, NP = (24, 24, 24), 6, 2.0, 1500


@functools.lru_cache(maxsize=None)
def _outputs(C: int):
    """Type 1 and type 2 of the port's blocked complex128 plan, the JAX ds
    plan and the JAX float64 reference plan on the same seeded inputs."""
    rng = np.random.default_rng(40 + C)
    pts = rng.uniform(0, 2 * np.pi, (3, NP))
    v = random_complex(rng, np.complex128, (C, NP))
    u = random_complex(rng, np.complex128, (C,) + SHAPE)
    kw = dict(m=M, sigma=SIGMA, ntransforms=C)
    tp = tnufft.set_points(
        tnufft.PlanNUFFT(np.complex128, SHAPE, spread_method="blocked",
                         precision="double", device="cpu", **kw), pts)
    dsp = jnufft.set_points(
        jnufft.PlanNUFFT(np.complex128, SHAPE, spread_method="blocked",
                         precision="double", interpret=True, np_hint=NP, **kw), pts)
    assert dsp.ds
    ref = jnufft.set_points(jnufft.PlanNUFFT(np.complex128, SHAPE, **kw), pts)
    out = {}
    for name, plan, pkg in (("port", tp, tnufft), ("ds", dsp, jnufft), ("ref", ref, jnufft)):
        u1, v2 = pkg.exec_type1(plan, v), pkg.exec_type2(plan, u)
        out[name] = tuple(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
                          for x in (u1, v2))
    return out


@pytest.mark.parametrize("C", [1, 3])
def test_complex128_blocked_matches_jax_ds(C):
    out = _outputs(C)
    u1, v2 = out["port"]
    assert u1.dtype == v2.dtype == np.complex128
    assert u1.shape == (C,) + SHAPE and v2.shape == (C, NP)
    assert rel_err(u1, out["ds"][0]) <= TOL_DS
    assert rel_err(v2, out["ds"][1]) <= TOL_DS


@pytest.mark.parametrize("C", [1, 3])
def test_complex128_blocked_matches_jax_f64_reference(C):
    out = _outputs(C)
    assert rel_err(out["port"][0], out["ref"][0]) <= TOL_F64
    assert rel_err(out["port"][1], out["ref"][1]) <= TOL_F64


def test_complex128_blocked_state_is_float64():
    """Nothing on the 64-bit path is float32: fractions, coefficients,
    deconvolution factors and the normalisation (a Python float)."""
    plan = tnufft.PlanNUFFT(np.complex128, (16, 16, 16), m=4, sigma=1.5,
                            spread_method="blocked", device="cpu")
    plan = tnufft.set_points(plan, np.random.default_rng(1).uniform(0, 7, (3, 50)))
    assert plan.fracs_sorted.dtype == plan.coefs.dtype == torch.float64
    assert all(p.dtype == torch.float64 for p in plan.phihat_inv)
    assert all(kd.cs_poly.dtype == torch.float64 for kd in plan.kernel_data)
    assert isinstance(plan.normfactor, float)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_interop_from_jax_ds_plan(dtype):
    """A JAX double-single plan's (hi, lo) coefficients and deconvolution
    factors, summed in float64, give the port's own float64 plan."""
    shape = (16, 12, 20)
    kw = dict(m=6, sigma=2.0)
    jp = jnufft.PlanNUFFT(dtype, shape, spread_method="blocked", precision="double",
                          interpret=True, **kw)
    assert jp.ds
    tp = tnufft.PlanNUFFT(dtype, shape, spread_method="blocked", device="cpu", **kw)
    data = plan_data_from_numpy(
        kind=jp.kernel_data[0].kind,
        cs_poly=[np.asarray(kd.cs_poly) for kd in jp.kernel_data],
        cs_poly_lo=[np.asarray(kd.cs_poly_lo) for kd in jp.kernel_data],
        beta=[kd.beta for kd in jp.kernel_data],
        peak=[kd.peak for kd in jp.kernel_data],
        phihat_inv=[np.asarray(p) for p in jp.phihat_inv],
        phihat_inv_lo=[np.asarray(p) for p in jp.phihat_inv_lo],
        index_ranges=jp.index_ranges,
        shape_over=jp.shape_over,
    )
    assert data["shape_over"] == tp.shape_over
    assert data["index_ranges"] == tp.index_ranges
    assert rel_err(data["coefs"].numpy(), tp.coefs.numpy()) <= TOL_INTEROP
    for a, b in zip(data["phihat_inv"], tp.phihat_inv):
        assert rel_err(a.numpy(), b.numpy()) <= TOL_INTEROP
    # Without the lo halves the coefficients are float32-accurate only.
    hi_only = np.stack([np.asarray(kd.cs_poly, np.float64).T for kd in jp.kernel_data])
    assert rel_err(hi_only, tp.coefs.numpy()) > 1e-9
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 2 * np.pi, (3, 300))
    v = random_complex(rng, np.complex128, 300)
    if np.dtype(dtype).kind == "f":
        v = v.real.copy()
    u_own = tnufft.exec_type1(tnufft.set_points(tp, pts), v).numpy()
    tp_j = dataclasses.replace(tp, **data)
    u_ds = tnufft.exec_type1(tnufft.set_points(tp_j, pts), v).numpy()
    assert rel_err(u_ds, u_own) <= TOL_INTEROP


@pytest.mark.parametrize("dtype", list(VALUE_TYPES), ids=str)
@pytest.mark.parametrize("m", list(KERNEL_M_RANGE))
def test_geometry_fits_shared_memory_at_384(dtype, m):
    """The chosen block of every value type and M at grid 384^3 fits one
    CTA's shared memory and leaves at least two blocks per SM."""
    _, scalar_bytes, ncomp = VALUE_TYPES[dtype]
    bd = blocking.choose_geometry((384, 384, 384), m, scalar_bytes, ncomp)
    assert all(384 % b == 0 for b in bd)
    assert spread_smem_bytes(bd, m, m + 4, scalar_bytes, ncomp) <= MAX_SMEM_BYTES
    assert int(np.prod(blocking.num_blocks((384,) * 3, bd))) >= 2 * 132
