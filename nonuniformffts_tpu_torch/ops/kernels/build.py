"""Build and load the hand-written CUDA kernels (``csrc/``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The build
happens at first use (never at import), goes to
``build/nonuniformffts_tpu_torch/`` at the repository root, and is redone
when a hash of the sources and flags changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "nonuniformffts_tpu_torch"
LIB_NAME = "libnufft_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # vals, cells, fracs, pstarts, coefs, grid, np, nchan, m, ncoef,
    # n0, n1, n2, b0, b1, b2, stream
    "nufft_spread_3d_f32": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # grid, cells, fracs, perm, coefs, out, np, nchan, m, ncoef,
    # n0, n1, n2, normfactor, stream
    "nufft_interp_3d_f32": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                            _I, _I, _I, _I, _I, ctypes.c_float, _P],
}

_lib = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of nonuniformffts_tpu_torch are built from csrc/ at first use"
        )
    return path


def build(*, ptxas_verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library matches the sources.
    Returns the library path; ``ptxas_verbose`` prints each kernel's
    registers, shared memory and spills."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", tmp, *map(str, cu)]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if ptxas_verbose:
        print(res.stderr, flush=True)
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
