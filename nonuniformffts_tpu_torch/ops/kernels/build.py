"""Build and load the hand-written CUDA kernels (``csrc/``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` once per value type
(``-DNUFFT_ONLY=<index into VALUE_SUFFIXES>``), all compiles started together,
and links the objects into one shared library with a plain C interface,
which is loaded with ``ctypes``.  The build happens at first use (never at
import), goes to ``build/nonuniformffts_tpu_torch/`` at the repository
root, and is redone when a hash of the sources and flags changes.  What
``ptxas -v`` says of each kernel (registers, spills, shared memory), and
when each compile finished, is kept beside the library in ``ptxas.log``.
Processes that start together (the ranks of a ``torchrun`` job) take a file
lock around the build: one of them compiles, the others wait and load.
What the load cost this process is kept in ``LOAD``.
"""

from __future__ import annotations

import ctypes
import fcntl
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
LOCK_PATH = BUILD_DIR / "build.lock"
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


class BinGeometry(ctypes.Structure):
    """``csrc/bin_sort.cu:BinGeometry``, the grid and block dims and the cell
    scale (``ops/windows.py:cell_scale``) a dim of the set_points kernels
    (missing dims stay 0)."""

    _fields_ = [("ndim", ctypes.c_int), ("n", ctypes.c_int * 3), ("b", ctypes.c_int * 3),
                ("scale", ctypes.c_double * 3)]

    @classmethod
    def of(cls, shape_over, block_dims, scales) -> "BinGeometry":
        out = cls(ndim=len(shape_over))
        out.n[: len(shape_over)] = [int(n) for n in shape_over]
        out.b[: len(block_dims)] = [int(b) for b in block_dims]
        out.scale[: len(scales)] = [float(s) for s in scales]
        return out


class DeconvGeometry(ctypes.Structure):
    """``csrc/deconvolve.cu:DeconvGeometry``, the transforms and the three
    axes of the deconvolution kernels (``common.py:DeconvolveAxes``)."""

    _fields_ = [("transforms", ctypes.c_longlong)] + [
        (name, ctypes.c_int * 3) for name in ("out", "over", "start0", "len0", "start1")]

    @classmethod
    def of(cls, transforms: int, axes) -> "DeconvGeometry":
        out = cls(transforms=int(transforms))
        for name, _ in cls._fields_[1:]:
            getattr(out, name)[:] = getattr(axes, name)
        return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_HEAD = [_P] * 7 + [ctypes.c_longlong, _I, _I, _I]
_SIGNATURES = {}
for _d in KERNEL_DIMS:
    for _vt in VALUE_SUFFIXES:
        # vals, cells, fracs, pstarts, coefs, wtaps, grid, [perm,] np, nchan,
        # m, ncoef, n_0..n_{D-1}, b_0..b_{D-1}, stream: the 1D kernel reads
        # the values in the caller's order (csrc/spread_1d.cu)
        _SIGNATURES[f"nufft_spread_{_d}d_{_vt}"] = (
            _HEAD[:7] + [_P] * (_d == 1) + _HEAD[7:] + [_I] * (2 * _d) + [_P])
        # grid, cells, fracs, perm, [pstarts,] coefs, wtaps, out, [sorted,
        # inv,] np, nchan, m, ncoef, n_0..n_{D-1}, [b_0..b_{D-1},]
        # normfactor, stream: the 1D and 3D kernels walk the blocks, and the
        # 1D one may put its results in order through a scratch table
        # (csrc/interp_{1,3}d.cu)
        _SIGNATURES[f"nufft_interp_{_d}d_{_vt}"] = (
            [_P] * 8 + [_P] * 2 * (_d == 1) + _HEAD[7:] + [_I] * (2 * _d) if _d != 2
            else _HEAD + [_I] * _d) + [ctypes.c_double, _P]
for _vt in ("f32", "f64"):
    # src, dst, runs, run_len, n0, b0, n1, b1, nb2, stream (csrc/relayout.cu)
    for _dir in ("grid", "blocks"):
        _SIGNATURES[f"nufft_relayout_to_{_dir}_{_vt}"] = (
            [_P, _P, ctypes.c_longlong, ctypes.c_longlong] + [_I] * 5 + [_P])
for _vt in ("f32", "f64"):
    # fracs, window, out, np, ndim, m, stream
    _SIGNATURES[f"nufft_window_weights_{_vt}"] = [
        _P, ctypes.POINTER(WindowParams), _P, ctypes.c_longlong, _I, _I, _P]
    # pts, geometry, keys, records, np, stream; records, sorted keys, perm,
    # geometry, cells, fracs, pstarts, np, stream (csrc/bin_sort.cu)
    _geom = ctypes.POINTER(BinGeometry)
    _SIGNATURES[f"nufft_bin_keys_{_vt}"] = [_P, _geom, _P, _P, ctypes.c_longlong, _P]
    _SIGNATURES[f"nufft_sorted_state_{_vt}"] = (
        [_P] * 3 + [_geom] + [_P] * 3 + [ctypes.c_longlong, _P])

_geom = ctypes.POINTER(DeconvGeometry)
for _vt in VALUE_SUFFIXES:
    # in, out, p0, p1, p2, normfactor | scale, geometry, vec, stream
    # (csrc/deconvolve.cu)
    _SIGNATURES[f"nufft_deconvolve_truncate_{_vt}"] = [_P] * 5 + [ctypes.c_double, _geom, _I, _P]
    _SIGNATURES[f"nufft_deconvolve_pad_{_vt}"] = [_P] * 5 + [_I, _geom, _I, _P]

_lib = None
#: The kernel library's load in this process (:func:`build` and
#: :func:`load`): seconds hashing the sources (``hash_s``), from a stale or
#: missing stamp to the library on disk, the lock's wait included
#: (``compile_s``, 0 when the stamp matched), in ``ctypes.CDLL``
#: (``dlopen_s``), and the nvcc builds this process ran (``builds``).
LOAD = {"hash_s": 0.0, "compile_s": 0.0, "dlopen_s": 0.0, "builds": 0}


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
    Returns the library path.  Holds ``LOCK_PATH`` while it checks and
    builds, so that of several processes only the first compiles."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    t0 = time.perf_counter()
    digest = source_hash()
    t1 = time.perf_counter()
    LOAD["hash_s"] += t1 - t0
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
                return lib_path
            _compile(lib_path)
            stamp.write_text(digest)
            LOAD["builds"] += 1
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
            LOAD["compile_s"] += time.perf_counter() - t1
    return lib_path


def _compile(lib_path: Path, sources=None, flags=(), log_path: Path = PTXAS_LOG) -> None:
    """Compile every source (default: all of ``csrc/``) once per value type,
    all at once, with ``flags`` added, and link into ``lib_path``."""
    nvcc = _nvcc()
    cu = _sources()[0] if sources is None else [CSRC_DIR / name for name in sources]
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        t0 = time.perf_counter()
        jobs = []
        for src in cu:
            for idx, vt in enumerate(VALUE_SUFFIXES):
                obj = Path(tmp) / f"{src.stem}_{vt}.o"
                log = open(Path(tmp) / f"{src.stem}_{vt}.log", "w+")
                cmd = [nvcc, *COMPILE_FLAGS, *flags, f"-DNUFFT_ONLY={idx}", f"-I{CSRC_DIR}",
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
        log_path.write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        out = Path(tmp) / lib_path.name
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
             *(str(obj) for _, obj, _, _ in jobs)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(out, lib_path)


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the signature of each entry point it exports."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build_variants(variants, sources=("relayout.cu",)):
    """Build ``sources`` (file names in ``csrc/``) once for each variant, a
    name mapped to extra nvcc flags (``-D`` values of a source's tunables),
    all variants at once, each into its own library under
    ``BUILD_DIR/variants/``; returns ``{name: loaded library}``.  For timing
    design alternatives (``chip_probe.py --relayout``); the package itself
    loads :func:`load`'s library only."""
    from concurrent.futures import ThreadPoolExecutor

    paths = {}
    for i, name in enumerate(variants):
        d = BUILD_DIR / "variants" / str(i)
        d.mkdir(parents=True, exist_ok=True)
        paths[name] = d / LIB_NAME
    with ThreadPoolExecutor(len(variants)) as pool:
        for f in [pool.submit(_compile, paths[name], sources, tuple(flags),
                              paths[name].parent / "ptxas.log")
                  for name, flags in variants.items()]:
            f.result()
    return {name: _typed(ctypes.CDLL(str(path))) for name, path in paths.items()}


def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    global _lib
    if _lib is None:
        path = build()
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(path))
        LOAD["dlopen_s"] += time.perf_counter() - t0
        _lib = _typed(lib)
    return _lib
