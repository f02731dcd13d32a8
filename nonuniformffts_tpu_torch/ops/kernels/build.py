"""Build and load the hand-written CUDA kernels (``csrc/``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` once per value type
(``-DNUFFT_ONLY=<index into VALUE_SUFFIXES>``), all compiles started together,
and links the objects into one shared library with a plain C interface,
which is loaded with ``ctypes``.  The build happens at first use (never at
import), goes to ``build/nonuniformffts_tpu_torch/`` at the repository
root, and is redone when a hash of the sources and flags changes.  What
``ptxas -v`` says of each kernel (registers, spills, shared memory), and
when each compile finished, is kept beside the library in ``ptxas.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from .common import KERNEL_DIMS, VALUE_TYPES

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "nonuniformffts_tpu_torch"
LIB_NAME = "libnufft_kernels.so"
PTXAS_LOG = BUILD_DIR / "ptxas.log"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
#: Entry-point suffixes of each kernel, in the order of ``NUFFT_ONLY``
#: (``csrc/*.cu``: 0 complex64, 1 complex128, 2 float32, 3 float64).
VALUE_SUFFIXES = tuple(suffix for suffix, _, _ in VALUE_TYPES.values())


class WindowParams(ctypes.Structure):
    """``csrc/window.cuh:WindowParams``, the argument of the window-weights
    kernel, filled from a ``ops/windows.py:WindowPack`` (missing dims stay
    0)."""

    _fields_ = [("kind", ctypes.c_int)] + [
        (name, ctypes.c_double * 3)
        for name in ("beta", "inv_peak", "pref", "exp_mbeta", "inv_tau", "dx")
    ]

    @classmethod
    def from_pack(cls, pack) -> "WindowParams":
        out = cls(kind=pack.kind)
        for name, _ in cls._fields_[1:]:
            getattr(out, name)[: len(getattr(pack, name))] = getattr(pack, name)
        return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_HEAD = [_P] * 7 + [ctypes.c_longlong, _I, _I, _I]
_SIGNATURES = {}
for _d in KERNEL_DIMS:
    for _vt in VALUE_SUFFIXES:
        # vals, cells, fracs, pstarts, coefs, wtaps, grid, np, nchan, m,
        # ncoef, n_0..n_{D-1}, b_0..b_{D-1}, stream
        _SIGNATURES[f"nufft_spread_{_d}d_{_vt}"] = _HEAD + [_I] * (2 * _d) + [_P]
        # grid, cells, fracs, perm, coefs, wtaps, out, np, nchan, m, ncoef,
        # n_0..n_{D-1}, normfactor, stream
        _SIGNATURES[f"nufft_interp_{_d}d_{_vt}"] = _HEAD + [_I] * _d + [ctypes.c_double, _P]
for _vt in ("f32", "f64"):
    # fracs, window, out, np, ndim, m, stream
    _SIGNATURES[f"nufft_window_weights_{_vt}"] = [
        _P, ctypes.POINTER(WindowParams), _P, ctypes.c_longlong, _I, _I, _P]

_lib = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + VALUE_SUFFIXES).encode())
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


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library matches the sources.
    Returns the library path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        jobs = []
        for src in cu:
            for idx, vt in enumerate(VALUE_SUFFIXES):
                obj = Path(tmp) / f"{src.stem}_{vt}.o"
                log = open(Path(tmp) / f"{src.stem}_{vt}.log", "w+")
                cmd = [nvcc, *COMPILE_FLAGS, f"-DNUFFT_ONLY={idx}", f"-I{CSRC_DIR}",
                       "-c", "-o", str(obj), str(src)]
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
                jobs.append((f"{src.name} [{vt}]", obj, proc, log))
        done = {}
        while len(done) < len(jobs):  # wait for every compile before raising
            for name, _, proc, _ in jobs:
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
            time.sleep(0.05)
        failed, logs = [], []
        for name, _, proc, log in jobs:
            log.seek(0)
            err = log.read()
            log.close()
            logs.append(f"--- {name} ({done[name]:.1f} s)\n{err}")
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
        PTXAS_LOG.write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        out = Path(tmp) / LIB_NAME
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
             *(str(obj) for _, obj, _, _ in jobs)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(out, lib_path)
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
