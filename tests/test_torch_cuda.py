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

# float32 atomics add in a run-dependent order; ~1e-7 expected.
KERNEL_TOL = 1e-5


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


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


@pytest.mark.parametrize("m", [2, 4, 8])
def test_kernels_match_plain_versions(cuda_device, m):
    """K1 and K2 at 32^3 (grid 48^3) against their plain versions, with the
    launch counts moving."""
    rng = np.random.default_rng(m)
    plan = tnufft.PlanNUFFT(np.complex64, (32, 32, 32), m=m, sigma=1.5,
                            ntransforms=2, spread_method="blocked",
                            device=cuda_device)
    pts = rng.uniform(-1.0, 7.0, (3, 20_000)).astype(np.float32)
    pts[:, :50] = np.nextafter(np.float32(2 * np.pi), np.float32(0))
    plan = tnufft.set_points(plan, torch.from_numpy(pts).to(cuda_device))
    vp = torch.from_numpy(_complex(rng, (2, 20_000))).to(cuda_device)
    grid = torch.from_numpy(_complex(rng, (2,) + plan.shape_over)).to(cuda_device)
    before = dict(blocked.LAUNCHES)
    g_k = blocked.spread_blocked(plan, vp)
    v_k = blocked.interpolate_blocked(plan, grid)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES["nufft_spread_3d_f32"] == before["nufft_spread_3d_f32"] + 1
    assert blocked.LAUNCHES["nufft_interp_3d_f32"] == before["nufft_interp_3d_f32"] + 1
    g_p = blocked.spread_blocked_plain(plan, vp)
    v_p = blocked.interpolate_blocked_plain(plan, grid)
    assert _rel_err(g_k, g_p) <= KERNEL_TOL
    assert _rel_err(v_k, v_p) <= KERNEL_TOL
