"""The hand-written CUDA kernels against their plain PyTorch versions on the
card.  Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; elsewhere every test
here skips.  The file imports no JAX, so on a GPU host without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -s
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.ops.kernels import blocked

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# float32 atomics add in a run-dependent order (~1e-7 expected); float64
# atomics reorder sums at ~1e-16.
KERNEL_TOL = {4: 1e-5, 8: 1e-12}
DTYPES = [np.complex64, np.complex128, np.float32, np.float64]


def _values(rng, dtype, shape):
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _rel_err(a, b) -> float:
    return float(((a - b).abs().pow(2).sum() / b.abs().pow(2).sum()).sqrt())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_toolchain(cuda_device):
    """Record which toolchain the GPU host has."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    has_nvcc = Path(nvcc).exists()
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"triton {triton_version}, nvcc {'found' if has_nvcc else 'missing'}")
    if has_nvcc:
        print(subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1])
    print(torch.cuda.get_device_name(0))
    assert has_nvcc


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize(
    "shape,block_dims",
    [((32, 32, 32), None), ((64, 48), None), ((64, 48), (16, 24)),
     ((4096,), None), ((4096,), (512,))],
    ids=str,
)
def test_kernels_match_plain_versions(cuda_device, shape, block_dims, m, dtype):
    """Each spread and interpolation entry point (3D at 32^3, grid 48^3; 2D
    at 64 x 48; 1D at 4096, ~3 points a cell) against its plain version,
    with the launch counts moving."""
    rng = np.random.default_rng(m)
    D = len(shape)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=1.5, ntransforms=2,
                            spread_method="blocked", block_dims=block_dims,
                            device=cuda_device)
    real = np.dtype(dtype).type(0).real.dtype
    pts = rng.uniform(-1.0, 7.0, (D, 20_000)).astype(real)
    pts[:, :50] = np.nextafter(real.type(2 * np.pi), real.type(0))
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    vp = torch.from_numpy(_values(rng, dtype, (2, 20_000))).to(cuda_device)
    grid = torch.from_numpy(_values(rng, dtype, (2,) + plan.shape_over)).to(cuda_device)
    spread = blocked.entry_point("spread", plan)
    interp = blocked.entry_point("interp", plan)
    assert f"_{D}d_" in spread and f"_{D}d_" in interp
    before = dict(blocked.LAUNCHES)
    g_k = blocked.spread_blocked(plan, vp)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[spread] == before[spread] + 1
    assert blocked.LAUNCHES[interp] == before[interp] + 1
    g_p = blocked.spread_blocked_plain(plan, vp)
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    tol = KERNEL_TOL[np.dtype(real).itemsize]
    assert g_k.dtype == g_p.dtype == plan.dtype
    assert _rel_err(g_k, g_p) <= tol
    assert _rel_err(v_k, v_p) <= tol


WINDOWS = [
    ("KaiserBesselKernel", "FastApproximation"),
    ("KaiserBesselKernel", "Direct"),
    ("BackwardsKaiserBesselKernel", "FastApproximation"),
    ("BackwardsKaiserBesselKernel", "Direct"),
    ("GaussianKernel", "FastApproximation"),
    ("GaussianKernel", "Direct"),
    ("BSplineKernel", "FastApproximation"),
    ("BSplineKernel", "Direct"),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("m", [3, 10])
@pytest.mark.parametrize("shape", [(24, 24, 24), (64, 48), (4096,)], ids=str)
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_window_kernels_match_plain_versions(cuda_device, window, shape, m, dtype):
    """Every window in both modes, at m = 3 and m = 10 (sigma = 2), each
    entry point against its plain version.  The plain fast Gaussian uses
    fast Gaussian gridding, the kernels one exp per node: they agree to
    rounding."""
    rng = np.random.default_rng(m + 17)
    D = len(shape)
    kernel, mode = (getattr(tnufft, n)() for n in window)
    plan = tnufft.PlanNUFFT(dtype, shape, m=m, sigma=2.0, ntransforms=2, kernel=kernel,
                            kernel_evalmode=mode, spread_method="blocked",
                            device=cuda_device)
    real = np.dtype(dtype).type(0).real.dtype
    pts = rng.uniform(-1.0, 7.0, (D, 5_000)).astype(real)
    pts[:, :20] = np.nextafter(real.type(2 * np.pi), real.type(0))
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    vp = torch.from_numpy(_values(rng, dtype, (2, 5_000))).to(cuda_device)
    grid = torch.from_numpy(_values(rng, dtype, (2,) + plan.shape_over)).to(cuda_device)
    spread = blocked.entry_point("spread", plan)
    interp = blocked.entry_point("interp", plan)
    weights = blocked.WEIGHTS_ENTRY[plan.real_dtype]
    horner = blocked.kernel_coefs(plan)[0] is not None
    before = dict(blocked.LAUNCHES)
    g_k = blocked.spread_blocked(plan, vp)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES[spread] == before[spread] + 1
    assert blocked.LAUNCHES[interp] == before[interp] + 1
    assert blocked.LAUNCHES[weights] == before[weights] + (0 if horner else 2)
    g_p = blocked.spread_blocked_plain(plan, vp)
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    tol = KERNEL_TOL[np.dtype(real).itemsize]
    assert torch.isfinite(torch.view_as_real(g_k) if g_k.is_complex() else g_k).all()
    assert _rel_err(g_k, g_p) <= tol
    assert _rel_err(v_k, v_p) <= tol
    if not horner:  # K3 against its plain version, the kernels' tap twin
        w_k = blocked.window_weights_blocked(plan)
        assert w_k.shape == (D, 2 * m, 5_000)
        assert _rel_err(w_k, blocked.window_weights_blocked_plain(plan)) <= tol


def test_m_above_10_raises(cuda_device):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnufft.PlanNUFFT(np.complex64, (64, 64), m=11, sigma=2.0, device=cuda_device)
