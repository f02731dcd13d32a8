"""The PyTorch port's transforms end to end on the CPU against the JAX
package and the exact sums.

The blocked case is the main path at a small size: the port's
``spread_method='blocked'`` plan (the kernel wrappers run their plain
versions on CPU tensors) against the JAX package's blocked plan with the
Pallas kernels in interpret mode and the pruned matmul DFT, which resolves
to the z-form kernels ``_spread_kernel_z`` / ``_interp_kernel_z``.
"""

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.ops.deconvolve import output_wavenumbers
from nonuniformffts_tpu_torch.ops.kernels import blocked
from nufft_test_utils import direct_type1, direct_type2
from torch_port_utils import random_complex, random_points, rel_err

torch.set_num_threads(1)

# Port against JAX: the same algorithm, summed in another order.
TOL_JAX = {np.complex64: 1e-5, np.complex128: 1e-10}
# Against the exact sums: the m = 4, sigma = 1.5 budget (~2e-6 measured).
TOL_EXACT = 1e-5


def _kvecs(shape, fftshift=False):
    return [output_wavenumbers(n, r2c=False, fftshift=fftshift) for n in shape]


def _run_port(plan, pts, v, u):
    plan = tnufft.set_points(plan, pts)
    return tnufft.exec_type1(plan, v).numpy(), tnufft.exec_type2(plan, u).numpy()


def _run_jax(plan, pts, v, u):
    plan = jnufft.set_points(plan, pts)
    return np.asarray(jnufft.exec_type1(plan, v)), np.asarray(jnufft.exec_type2(plan, u))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_blocked_main_path_matches_jax_kernels(dtype):
    rng = np.random.default_rng(21)
    shape = (16, 16, 16)
    kw = dict(m=4, sigma=1.5)
    pts = random_points(rng, 3, 400, dtype)
    v = random_complex(rng, dtype, 400)
    u = random_complex(rng, dtype, shape)
    tp = tnufft.PlanNUFFT(dtype, shape, spread_method="blocked", device="cpu", **kw)
    jp = jnufft.PlanNUFFT(dtype, shape, spread_method="blocked", interpret=True,
                          fft_method="matmul", fft_variant="pruned", **kw)
    assert jp.kernel_form == "z"
    u1, v2 = _run_port(tp, pts, v, u)
    ju1, jv2 = _run_jax(jp, pts, v, u)
    assert u1.shape == shape and v2.shape == (400,)
    assert u1.dtype == v2.dtype == np.dtype(dtype)
    assert rel_err(u1, ju1) <= TOL_JAX[dtype]
    assert rel_err(v2, jv2) <= TOL_JAX[dtype]
    x = pts.astype(np.float64)
    assert rel_err(u1, direct_type1(x, v, _kvecs(shape))) <= TOL_EXACT
    assert rel_err(v2, direct_type2(x, u, _kvecs(shape))) <= TOL_EXACT


@pytest.mark.parametrize(
    "shape,dtype,C,extra",
    [
        ((24,), np.complex128, 1, {}),
        ((16, 12), np.complex128, 2, dict(fftshift=True)),
        ((12, 10, 14), np.complex128, 1, dict(sort_points=True, chunk_size=77)),
        ((12, 10, 14), np.complex64, 2, {}),
        ((10, 12, 8), np.complex128, 1, dict(kernel="KaiserBesselKernel",
                                             kernel_evalmode="Direct")),
        ((10, 12, 8), np.complex128, 1, dict(kernel="GaussianKernel")),
        ((10, 12, 8), np.complex128, 1, dict(kernel="BSplineKernel")),
    ],
    ids=lambda v: getattr(v, "__name__", str(v)),
)
@pytest.mark.parametrize("method", ["reference", "blocked"])
def test_transforms_match_jax_reference(shape, dtype, C, extra, method):
    """Both port methods against the JAX reference path, over dims, windows,
    fftshift, ntransforms, chunking and the spatial sort."""
    rng = np.random.default_rng(22)
    pts = random_points(rng, len(shape), 250, dtype)
    v = random_complex(rng, dtype, (C, 250))
    u = random_complex(rng, dtype, (C,) + shape)
    if C == 1:
        v, u = v[0], u[0]

    def build(pkg, **more):
        # Window classes are named in `extra`; each package has its own.
        opts = dict(m=4, sigma=1.5, ntransforms=C, **extra, **more)
        for key in ("kernel", "kernel_evalmode"):
            if key in opts:
                opts[key] = getattr(pkg, opts[key])()
        return pkg.PlanNUFFT(dtype, shape, **opts)

    tp = build(tnufft, spread_method=method, device="cpu")
    jp = build(jnufft, spread_method="reference")
    u1, v2 = _run_port(tp, pts, v, u)
    ju1, jv2 = _run_jax(jp, pts, v, u)
    assert rel_err(u1, ju1) <= TOL_JAX[dtype]
    assert rel_err(v2, jv2) <= TOL_JAX[dtype]


@pytest.mark.parametrize("method", ["reference", "blocked"])
def test_points_near_two_pi_and_shifted(method):
    """Points at nextafter(2pi, 0) in f32 stay in bounds, and points
    shifted by multiples of 2pi give the same transforms."""
    rng = np.random.default_rng(23)
    shape = (12, 12, 12)
    plan = tnufft.PlanNUFFT(np.complex64, shape, m=4, sigma=1.5,
                            spread_method=method, device="cpu")
    pts = random_points(rng, 3, 200, np.complex64)
    pts[:, :20] = np.nextafter(np.float32(2 * np.pi), np.float32(0))
    pts[0, 20:40] = 0.0
    v = random_complex(rng, np.complex64, 200)
    u = random_complex(rng, np.complex64, shape)
    u1, v2 = _run_port(plan, pts, v, u)
    assert np.isfinite(u1).all() and np.isfinite(v2).all()
    x = pts.astype(np.float64)
    assert rel_err(u1, direct_type1(x, v, _kvecs(shape))) <= TOL_EXACT
    assert rel_err(v2, direct_type2(x, u, _kvecs(shape))) <= TOL_EXACT
    shift = (pts.astype(np.float64) + 2 * np.pi * np.array([[2], [-1], [3]]))
    su1, sv2 = _run_port(plan, shift.astype(np.float32), v, u)
    assert rel_err(su1, u1) <= 1e-5 and rel_err(sv2, v2) <= 1e-5


def test_point_formats_agree():
    rng = np.random.default_rng(24)
    plan = tnufft.PlanNUFFT(np.complex128, (8, 10, 6), device="cpu")
    pts = random_points(rng, 3, 50, np.complex128)
    v = random_complex(rng, np.complex128, 50)
    outs = [
        tnufft.exec_type1(tnufft.set_points(plan, p), v).numpy()
        for p in (pts, pts.T.copy(), tuple(pts), list(torch.from_numpy(pts)))
    ]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    p1 = tnufft.set_points(tnufft.PlanNUFFT(np.complex128, 16, device="cpu"), pts[0])
    assert p1.num_points == 50


def test_error_paths():
    """The checks tests/test_errors.py pins for the JAX package."""
    rng = np.random.default_rng(25)
    with pytest.raises(ValueError, match="too small"):
        tnufft.PlanNUFFT(np.complex128, (4,), m=8, sigma=1.0, device="cpu")
    with pytest.raises(TypeError):
        tnufft.PlanNUFFT(np.int32, (16,), device="cpu")
    plan = tnufft.PlanNUFFT(np.complex128, (16,), device="cpu")
    with pytest.raises(ValueError, match="points not set"):
        tnufft.exec_type1(plan, np.zeros(4, np.complex128))
    p10 = tnufft.set_points(plan, rng.uniform(0, 1, 10))
    with pytest.raises(ValueError, match="number of values"):
        tnufft.exec_type1(p10, np.zeros(5, np.complex128))
    with pytest.raises(TypeError, match="dtype"):
        tnufft.exec_type1(p10, np.zeros(10, np.complex64))
    with pytest.raises(TypeError, match="dtype"):
        tnufft.exec_type2(p10, torch.zeros(16, dtype=torch.complex64))
    p2d = tnufft.set_points(tnufft.PlanNUFFT(np.complex128, (16, 16), device="cpu"),
                            rng.uniform(0, 1, (2, 10)))
    with pytest.raises(ValueError, match="shape"):
        tnufft.exec_type2(p2d, np.zeros((16, 8), np.complex128))
    pc2 = tnufft.set_points(
        tnufft.PlanNUFFT(np.complex128, (16,), ntransforms=2, device="cpu"),
        rng.uniform(0, 1, 10),
    )
    with pytest.raises(ValueError, match="ntransforms"):
        tnufft.exec_type1(pc2, np.zeros(10, np.complex128))
    with pytest.raises(ValueError, match="ntransforms"):
        tnufft.exec_type1(pc2, np.zeros((3, 10), np.complex128))
    plan2 = tnufft.PlanNUFFT(np.complex128, (16, 16), device="cpu")
    with pytest.raises(ValueError, match="equal lengths"):
        tnufft.set_points(plan2, (np.zeros(5), np.zeros(6)))
    with pytest.raises(ValueError):
        tnufft.set_points(plan2, (np.zeros(5),))
    with pytest.raises(ValueError):
        tnufft.PlanNUFFT(np.complex128, (8, 8, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="spread_method"):
        tnufft.PlanNUFFT(np.complex64, (16,), spread_method="bogus", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tnufft.PlanNUFFT(np.complex64, (16,), precision="bogus", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tnufft.PlanNUFFT(np.complex64, (16, 16, 16), spread_method="blocked",
                         block_dims=(5, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        tnufft.PlanNUFFT(np.complex64, (16, 16, 16), spread_method="blocked",
                         batch_size=100, device="cpu")


def test_unported_surface_raises():
    """The surface once left to later slices (the direct method, the timer,
    callbacks) now runs on a CPU plan; m > 10 raises; a plan runs on the
    CPU only when asked."""
    v = np.ones(3, np.complex64)
    timer = tnufft.Timer()
    for kw in (dict(spread_method="direct"), dict(timer=timer)):
        plan = tnufft.set_points(tnufft.PlanNUFFT(np.complex64, (16,), device="cpu", **kw),
                                 np.zeros(3, np.float32))
        assert tnufft.exec_type1(plan, v).shape == (16,)
    assert "exec_type1/(1) spreading" in timer.times
    cb = tnufft.NUFFTCallbacks(uniform=lambda w, i: tuple(2 * x for x in w))
    assert torch.equal(tnufft.exec_type1(plan, v, callbacks=cb), 2 * tnufft.exec_type1(plan, v))
    # The CUDA kernels take 1-3D plans of every window in both modes, m up
    # to 10; m = 11 is refused naming the JAX package's documented maximum.
    for dtype, shape in ((np.float64, (16, 16)), (np.float32, (40,))):
        blocked.check_kernel_support(tnufft.PlanNUFFT(
            dtype, shape, spread_method="blocked", device="cpu"))
    for dtype, shape, kw in ((np.complex128, (8, 8, 8), dict(kernel_evalmode=tnufft.Direct())),
                             (np.float64, (16, 16), dict(kernel_evalmode=tnufft.Direct())),
                             (np.complex64, (40,), dict(kernel=tnufft.GaussianKernel())),
                             (np.float32, (40,), dict(kernel=tnufft.BSplineKernel(), m=10))):
        blocked.check_kernel_support(tnufft.PlanNUFFT(
            dtype, shape, spread_method="blocked", device="cpu", **kw))
    p = tnufft.PlanNUFFT(np.complex64, (40,), m=11, spread_method="blocked", device="cpu")
    with pytest.raises(NotImplementedError, match="documented maximum"):
        blocked.check_kernel_support(p)
    if torch.cuda.is_available():
        assert tnufft.PlanNUFFT(np.complex64, (16,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnufft.PlanNUFFT(np.complex64, (16,))
        with pytest.raises(RuntimeError, match="is_available"):
            tnufft.PlanNUFFT(np.complex64, (16, 16, 16), device="cuda")
    assert tnufft.PlanNUFFT(np.complex64, (16,), device="cpu").spread_method == "reference"


def test_float32_error_at_rho_1_no_worse_than_jax():
    """ROADMAP queue 3, P2: at rho = 1 (24^3 modes, 13,824 points) the
    port's float32 type 1 is no further from the exact sums than the JAX
    package's float32 blocked main path (z-form kernels, interpret mode) on
    the same seeded inputs.  With float32 sums the port's plain spread gave
    1.81e-6 against JAX's 1.50e-6; the spread now sums in float64 (1.43e-6),
    and the float64 plan's 1.29e-6 is the window's own error."""
    rng = np.random.default_rng(3)
    N = 24
    shape, np_ = (N,) * 3, N**3
    pts = random_points(rng, 3, np_, np.complex64)
    v = random_complex(rng, np.complex64, np_)
    kidx = rng.integers(0, N, (256, 3))
    kval = np.where(kidx >= N // 2, kidx - N, kidx).astype(np.float64)
    exact = np.exp(-1j * (kval @ pts.astype(np.float64))) @ v.astype(np.complex128)

    def err1(pkg, **kw):
        plan = pkg.set_points(pkg.PlanNUFFT(np.complex64, shape, m=4, sigma=1.5,
                                            spread_method="blocked", **kw), pts)
        u = np.asarray(pkg.exec_type1(plan, v))
        return rel_err(u[kidx[:, 0], kidx[:, 1], kidx[:, 2]], exact)

    port = err1(tnufft, device="cpu")
    ref = err1(jnufft, interpret=True, fft_method="matmul", fft_variant="pruned")
    assert port <= ref <= TOL_EXACT
