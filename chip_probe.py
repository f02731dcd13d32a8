#!/usr/bin/env python3
"""Time the port's CUDA kernels on one NVIDIA GPU.

Every variant of a kernel that this script builds is a copy of the shipped
source in ``nonuniformffts_tpu_torch/csrc/`` with some of its lines
replaced (a ``*_PARTS`` table, ``_edited_sources``), built by this script
for the M it times into ``build/chip_probe/``; the one other design kept
here is the staged 2D interpolation (``_STAGED_INTERP_2D_SRC``).  Kernels
that the package replaced are not kept: PERF.md has their numbers.  Each
mode prints JSON lines with the card's name and power limit.  Needs one
CUDA device; exits non-zero without one.

    python3 chip_probe.py [--seed S] [--dim D ...] [--np N ...] [--dtype T ...]

times the spread wrapper (``ops/kernels/blocked.spread_blocked``) over block
geometries: for each dimension (3: N = 256^3, grid 384^3; 2: N = 4096^2,
grid 6144^2; 1: N = 2^20, grid 1,572,864), dtype (complex64, complex128,
float32, float64) and point count, at m = 4, sigma = 1.5, uniform random
points, at the geometry ``blocking.choose_geometry`` picks and at a few
others (CUDA events, median of 5 after one warm-up), in the order listed and
then in reverse; one JSON line per dimension, dtype and Np with the mean of
the two passes for each geometry (``blocking.BLOCKS_PER_SM_1D``).

    python3 chip_probe.py --spread3d [--dtype T ...] [--np N ...]
    python3 chip_probe.py --spread2d [--dtype T ...] [--np N ...]

time the 3D / 2D spread kernel's raw launches at the chooser's pick, held
against the plain version, and at the geometries around it
(``SPREAD3D_GEOMETRIES``, ``SPREAD2D_GEOMETRIES``): the sweeps that
``blocking.py:spread3d_cost`` and ``SPREAD2D_COST`` were fitted to.
``--spread2d`` sweeps the 2D main path's two densities and fits the 2D
model to them (``fit_spread2d``), with the pick the fit makes.

    python3 chip_probe.py --spread3d --against FILE [--nchan C ...] [--dtype T ...]
                          [--np N ...] [--reps N]

times another ``spread_3d.cu`` (an earlier commit's, ``git show
<commit>:nonuniformffts_tpu_torch/csrc/spread_3d.cu > FILE``) against the
shipped one in turns at the pick, C transforms a launch, with the share of
non-empty blocks whose points fit one batch.

    python3 chip_probe.py --spread3d-parts | --interp3d-parts | --spread2d-parts |
                          --interp2d-parts | --spread1d-parts | --interp1d-parts
                          [--m M ...] [--dtype T ...] [--np N ...] [--reps N]

time a kernel beside copies of its source with one phase taken out
(``PARTS``: ``SPREAD3D_PARTS``, ``INTERP3D_PARTS``, ``SPREAD2D_PARTS``,
``INTERP2D_PARTS`` with its first design's, ``POINT_INTERP2D_PARTS``,
``SPREAD1D_PARTS``, ``INTERP1D_PARTS``), to show where its time goes: raw
launches in turns on the same sorted points, beside the wrapper call and
its host time, at each dtype's main-path Np and 16,777,216 (1D: 1M and 10M;
``probe_parts``); a spread at each C of ``--nchan C ...`` transforms a
launch.

    python3 chip_probe.py --interp2d [--m M ...] [--dtype T ...] [--np N ...] [--reps N]

times the 2D interpolation kernel against its first design (the shipped
source with ``chunked_rows`` off, so that every M launches
``interp_2d_point_kernel``) and against a staged-window design tried in its
place (``_STAGED_INTERP_2D_SRC``), in turns, all held against the plain
version, at each dtype's main-path Np, 16,777,216 and 377,487 (rho = 0.01).

    python3 chip_probe.py --interp1d-sweep [--dtype T ...] [--np N ...] [--reps N]

times the 1D interpolation's point path against its staged path with the
gather, both forced, one and two transforms, from 1M to 10M points
(``INTERP1D_SWEEP_NP``), where ``INTERP1D_GATHER_BYTES`` chooses between
them.

    python3 chip_probe.py --weights [--m M ...] [--np N ...]

times the window-taps kernel K3 (``csrc/window_weights.cu``) as raw launches
beside its parts (``WEIGHTS_PARTS``) and its wrapper call, for the four
windows it evaluates, 3D at 1M and 16.8M points (``probe_weights``).

    python3 chip_probe.py --exec-1d [--reps N] [--root DIR]

times ``set_points``, ``exec_type1`` and ``exec_type2`` through the public
API on the 1D main path (chip_smoke.py phase 9, four dtypes at 1M and 10M
points) for the package of this tree or of the tree ``--root`` names, so
that two trees are timed in turns in one call (``probe_exec_1d``).

    python3 chip_probe.py --direct [--dtype complex64 complex128] [--np N ...]

times the direct NUDFT (``spread_method='direct'``) against the blocked
path through the public API at 256^3, 4096^2 and 2^20, Np = 1 to
100,000 (``DIRECT_NP``), with the direct path's errors against exact sums
and, for complex64, the same with complex64 factors; prints each row's
crossover Np and the ``c`` of ``ops/direct.py:prefers_direct`` that
matches it (``probe_direct``).

    python3 chip_probe.py --set-points [--dim D ...] [--dtype T ...] [--np N ...] [--reps N]

times ``set_points``' split and sort on the main paths' shapes (3D 256^3
and 2D 4096^2 at 16,777,216 points, 1D 2^20 at 10M; m = 4, sigma = 1.5):
the bin-key kernel, the sort and the sorted-state kernel
(``csrc/bin_sort.cu``) each alone and together, against the plain chain
they replace on the card (``blocking.py``), in turns, with their outputs
held equal and each kernel's bound by the function's bytes, on uniform
points and on clustered ones (empty end blocks, every point in the first or
the last block; ``probe_set_points``).

    python3 chip_probe.py --deconvolve [--reps N]

times the deconvolution's stages, whose kernels are ``csrc/deconvolve.cu``'s
truncate and pad, at N = 256^3 over the 384^3 grid: complex64 with 32
transforms a call (the 32-coil cell's), then one transform of each value
type against the plain torch chain, in turns, beside the bound by bytes
(``probe_deconvolve``).

    python3 chip_probe.py --alloc-window CELL ... [--seed S] [--seconds T] [--root DIR]

runs each benchmark cell as ``nufftbench/run.py`` does, traced and
untraced, and prints the device allocations made inside its measured
stretches: the caching allocator's new segments (counters and history,
with sizes and the repo's frames) and the ``cudaMalloc`` / ``cudaFree``
calls in the profiled trace (``probe_alloc_window``).  With ``--root`` the
harness and the package are those of another tree, so that two trees are
compared in one call.

    python3 chip_probe.py --gloo

asks which ``torch.distributed`` calls the gloo backend runs on CUDA
tensors: two gloo ranks on cuda:0 try each call on CUDA tensors and print
whether it ran and gave the right values, or the error it raised
(``nonuniformffts_tpu_torch/parallel/comm.py:GLOO_CUDA_OPS`` is read from
it; the library itself decides by the backend's name, never by an error).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPES = {3: (256,) * 3, 2: (4096, 4096), 1: (1 << 20,)}
DEFAULT_NP = {3: (1_677_722, 16_777_216), 2: (1_000_000, 16_777_216),
              1: (1_000_000, 10_000_000)}
GEOMETRIES = {
    3: ((12, 12, 16), (12, 24, 24), (24, 24, 12), (8, 16, 16), (16, 16, 16),
        (8, 8, 12), (8, 8, 8), (6, 8, 8), (8, 12, 12)),
    2: ((48, 96), (64, 96), (48, 64), (64, 64), (32, 128), (96, 128), (128, 128),
        (32, 64), (16, 128)),
    1: ((256,), (512,), (1024,), (2048,), (3072,), (4096,), (8192,), (16384,)),
}


def _probe_library(stem: str, text: str) -> ctypes.CDLL:
    """Build the CUDA source ``text`` (an edited copy of a ``csrc/`` file,
    which may include that directory's headers) into ``build/chip_probe/``
    with the package's nvcc flags; what ``ptxas -v`` says goes to
    ``<stem>.ptxas.log`` there."""
    from nonuniformffts_tpu_torch.ops.kernels import build

    out = ROOT / "build" / "chip_probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
    src.write_text(text)
    res = subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-O3", "-std=c++17", "-shared",
                          "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{build.CSRC_DIR}",
                          "-o", str(lib), str(src)], capture_output=True, text=True)
    (out / f"{stem}.ptxas.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}:\n{res.stderr[-4000:]}")
    return ctypes.CDLL(str(lib))


def _registers(log: Path, kernel: str) -> str:
    """Registers and spill stores of the instantiations of ``kernel`` (a
    regular expression) in the ptxas log ``log``."""
    regs = re.findall(r"(" + kernel + r")I(?:Li\dE)?Li(\d+)E([fd])(?:Li(\d)E)?(?:Lb([01])E)?.*?"
                      r"(\d+) bytes spill stores.*?Used (\d+) registers", log.read_text(), re.S)
    return ", ".join(f"{k} <M={m}, {t}{', ' + n if n else ''}{', taps' if b == '1' else ''}> "
                     f"{r} (spills {sp} B, {_resident_ctas(int(r))} CTAs of 256 an SM)"
                     for k, m, t, n, b, sp, r in regs)


def _ptxas_lines(log: Path) -> dict:
    """Each kernel instantiation's ptxas lines in the log ``log`` (stack,
    spills, registers, barriers, shared memory), by its label
    (``chip_smoke._kernel_label``)."""
    from chip_smoke import _kernel_label

    lines = {}
    for part in re.split(r"Compiling entry function '", log.read_text())[1:]:
        name = part.split("'", 1)[0]
        props = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill "
                          r"loads)", part)
        used = re.search(r"(Used \d+ registers[^\n]*)", part)
        lines[_kernel_label(name)] = (f"{props[1] if props else '?'}; "
                                      f"{used[1] if used else '?'}")
    return lines


def _probe_log(stem: str) -> Path:
    """The ptxas log of the probe's build ``stem`` (``_probe_library``)."""
    return ROOT / "build" / "chip_probe" / f"{stem}.ptxas.log"


GLOO_CALLS = ("all_to_all_single", "all_reduce", "all_gather", "all_gather_into_tensor",
              "broadcast", "send_recv", "batch_isend_irecv", "reduce_scatter_tensor")


def _gloo_call(call: str, rank: int) -> bool:
    """Run one torch.distributed call on CUDA tensors between two ranks;
    whether the result is right."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    base = torch.arange(8, dtype=torch.float64, device=dev)
    x, peer = base + 100 * rank, 1 - rank
    if call == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return torch.equal(out, torch.cat([base[4 * rank : 4 * rank + 4] + 100 * s
                                           for s in range(2)]))
    if call == "all_reduce":
        dist.all_reduce(x)
        return torch.equal(x, 2 * base + 100)
    if call == "all_gather":
        outs = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(outs, x)
        return all(torch.equal(o, base + 100 * s) for s, o in enumerate(outs))
    if call == "all_gather_into_tensor":
        out = torch.empty(16, dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out, torch.cat([base, base + 100]))
    if call == "broadcast":
        dist.broadcast(x, 0)
        return torch.equal(x, base)
    if call == "send_recv":
        if rank == 0:
            dist.send(x, 1)
            return True
        y = torch.empty_like(x)
        dist.recv(y, 0)
        return torch.equal(y, base)
    if call == "batch_isend_irecv":
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                           dist.P2POp(dist.irecv, y, peer)]):
            req.wait()
        return torch.equal(y, base + 100 * peer)
    out = torch.empty(4, dtype=x.dtype, device=dev)  # reduce_scatter_tensor
    dist.reduce_scatter_tensor(out, x)
    return torch.equal(out, 2 * base[4 * rank : 4 * rank + 4] + 100)


def _gloo_rank(rank: int, call: str, rdv: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    try:
        ok = _gloo_call(call, rank)
        torch.cuda.synchronize()
        print(f"  gloo {call} rank {rank}: {'ran, right' if ok else 'ran, WRONG'}", flush=True)
    except RuntimeError as e:  # what this probe asks
        print(f"  gloo {call} rank {rank}: {type(e).__name__}: {str(e)[:160]}", flush=True)
    dist.destroy_process_group()


def probe_gloo() -> None:
    import tempfile

    import torch
    import torch.multiprocessing as mp

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for call in GLOO_CALLS:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.start_processes(_gloo_rank, args=(call, f"{tmp}/rendezvous"), nprocs=2,
                                     join=False, start_method="spawn")
            deadline = time.monotonic() + 90
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    print(f"  gloo {call}: no answer in 90 s", flush=True)
                    break


def _host_us(fn, count: int = 2000) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    us = (time.perf_counter() - t0) / count * 1e6
    torch.cuda.synchronize()
    return us


#: Point counts of the 2D and 3D main paths by dtype (chip_smoke.py phases
#: 3-4 and 8).
MAIN_NP = {"complex64": 1_000_000, "float32": 1_000_000,
           "complex128": 1_677_722, "float64": 1_677_722}
#: Geometries the 3D kernel is timed at (grid 384^3).
SPREAD3D_GEOMETRIES = ((8, 8, 8), (8, 6, 8), (6, 8, 8), (8, 8, 6), (4, 8, 8), (8, 4, 8),
                       (8, 8, 4), (4, 4, 8), (6, 6, 8), (8, 8, 12), (8, 12, 8),
                       (8, 8, 16), (16, 8, 8), (24, 8, 8), (32, 8, 8), (12, 12, 16))
#: Geometries the 2D kernel is timed at for the cost model's fit (grid
#: 6144^2; the chooser's candidates: divisors up to 128).
SPREAD2D_GEOMETRIES = ((4, 16), (4, 32), (6, 16), (8, 8), (8, 16), (16, 8), (8, 24),
                       (8, 32), (8, 48), (12, 16), (12, 24), (16, 16), (16, 24),
                       (24, 16), (24, 24), (16, 32), (32, 32), (48, 64))
#: The densities of the 2D cost model's fit: the main path's two point counts.
SPREAD2D_FIT_NP = (1_000_000, 16_777_216)


def _raw_spread(lib, plan, vals):
    """One launch of the spread entry point of ``lib`` for the plan's
    dimension and value type on its sorted state, of the ``nchan`` =
    ``vals.shape[0]`` transforms of ``vals`` (in 3D one transform runs the
    per-transform kernel, more the shared-staging one); ``vals`` in sorted
    order in 2D and 3D, in the caller's order in 1D, where the kernel reads
    them through ``plan.sort_perm``.  Returns the grid."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    name = f"nufft_spread_{plan.ndim}d_{VALUE_TYPES[plan.dtype][0]}"
    fn = getattr(lib, name)
    sig = build._SIGNATURES[name]
    extra = (plan.sort_perm.data_ptr(),) if plan.ndim == 1 else ()
    if plan.ndim == 3:
        # A build whose kernel takes its items from a counter (it exports
        # the batch counts) takes the counter after the grid; an earlier
        # design's does not.
        if hasattr(lib, f"nufft_spread_3d_batches_{VALUE_TYPES[plan.dtype][0]}"):
            work = torch.zeros(1, dtype=torch.int32, device=vals.device)
            extra = (work.data_ptr(),)
        else:
            sig = sig[:7] + sig[8:]
    fn.argtypes = sig
    nchan = vals.shape[0]
    grid = torch.zeros((nchan,) + plan.shape_over, dtype=vals.dtype, device=vals.device)
    err = fn(vals.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.pstarts.data_ptr(), plan.coefs.data_ptr(), 0, grid.data_ptr(), *extra,
             plan.num_points, nchan, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *plan.block_dims, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return grid


def _raw_interp(lib, plan, grid, design: str = "nufft", gather=None, inv=None):
    """One launch of the interpolation entry point ``<design>_interp_<D>d_*``
    of ``lib`` for the plan's dimension and value type on its sorted state
    (the transforms of ``grid``).  The 1D and 3D kernels and the staged 2D
    one (``design`` 'staged') walk the blocks and take pstarts and the block
    dims; the 1D kernel stores its results sorted and gathers them into
    order through ``inv`` (default the plan's ``sort_perm_inv``) where
    ``gather`` says so, by default as the wrapper chooses
    (``common.interp1d_gathers``).  Returns the values."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES, interp1d_gathers

    D, suffix = plan.ndim, VALUE_TYPES[plan.dtype][0]
    name = f"{design}_interp_{D}d_{suffix}"
    fn = getattr(lib, name)
    sig = build._SIGNATURES[f"nufft_interp_{D}d_{suffix}"]
    walks = D != 2 or design == "staged"
    if D == 2 and walks:
        sig = sig[:4] + [ctypes.c_void_p] + sig[4:-2] + [ctypes.c_int] * 2 + sig[-2:]
    fn.argtypes = sig
    C = grid.shape[0]
    out = torch.empty((C, plan.num_points), dtype=grid.dtype, device=grid.device)
    order = ()
    if D == 1:
        if gather is None:
            gather = interp1d_gathers(plan.num_points, C, out.element_size())
        if not gather:
            order = (0, 0)
        else:
            if inv is None:
                inv = (plan.sort_perm_inv if plan.sort_perm_inv is not None
                       else _inverse(plan.sort_perm))
            scratch = torch.empty_like(out)
            order = (scratch.data_ptr(), inv.data_ptr())
    blocks = ((plan.pstarts.data_ptr(),), plan.block_dims) if walks else ((), ())
    err = fn(grid.data_ptr(), plan.cells_sorted.data_ptr(), plan.fracs_sorted.data_ptr(),
             plan.sort_perm.data_ptr(), *blocks[0], plan.coefs.data_ptr(), 0, out.data_ptr(),
             *order, plan.num_points, C, plan.m, plan.coefs.shape[-1], *plan.shape_over,
             *blocks[1], float(plan.normfactor), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def _plain_ends(plan, vp):
    """The plain version of the first and the last transform of ``vp``,
    ``(indices, grids)``: a plain spread of all of them at C = 32 and 16.8M
    points would need 29 GB of float64 sums."""
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    idx = sorted({0, vp.shape[0] - 1})
    chunked = dataclasses.replace(plan, chunk_size=1 << 16)
    return idx, [blocked.spread_blocked_plain(chunked, vp[c : c + 1])[0] for c in idx]


def _ends_err(got, ends) -> float:
    """The larger relative L2 gap of ``got``'s transforms at ``ends``
    (``_plain_ends``) to their plain versions."""
    from chip_smoke import rel_l2

    return max(rel_l2(got[c], w) for c, w in zip(*ends))


def _points_a_block(plan) -> dict:
    """Mean and largest points a block, the share of empty blocks, and the
    share of non-empty blocks whose points fit one batch of the 3D spread
    (``SPREAD3D_BATCH``: the shared-staging kernel stages them once)."""
    from nonuniformffts_tpu_torch.ops.kernels.common import SPREAD3D_BATCH

    counts = (plan.pstarts[1:] - plan.pstarts[:-1]).float()
    full = counts > 0
    return {"mean": float(counts.mean()), "max": int(counts.max()),
            "empty_share": float((~full).float().mean()),
            "one_batch_share": float(((counts <= SPREAD3D_BATCH) & full).sum() / full.sum())}


def _sweep(lib, plan0, pts, vp, dims):
    """The spread kernel's raw launch (``lib``) at each block geometry of
    ``dims``, in order and reversed, one plan at a time (CUDA events, median
    of 5 after one warm-up); ``{geometry: mean ms}``."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms

    gt = {g: [] for g in dims}
    for order in (dims, dims[::-1]):
        for g in order:
            plan = nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
            vals = vp[:, plan.sort_perm].contiguous()
            ms, _ = cuda_time_ms(lambda: _raw_spread(lib, plan, vals))
            gt[g].append(ms)
            del plan, vals
            torch.cuda.empty_cache()
    return {g: sum(t) / len(t) for g, t in gt.items()}


def _checked_pick(lib, plan0, pts, vp, tol: float) -> None:
    """The spread kernel's raw launch (``lib``) at the chooser's pick
    against the plain version."""
    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import rel_l2
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    plan = nufft.set_points(plan0, pts)
    want = blocked.spread_blocked_plain(dataclasses.replace(plan, chunk_size=1 << 16), vp)
    got = _raw_spread(lib, plan, vp[:, plan.sort_perm].contiguous())
    err = rel_l2(got, want)
    if not err <= tol:
        raise AssertionError(f"{plan.dtype} {plan.num_points}: rel L2 {err:.3e} vs plain")


def probe_spread3d(seed: int, dtypes, nps, nchans=(1,), against=None, reps: int = 5) -> None:
    """The 3D spread kernel at the chooser's pick and at
    ``SPREAD3D_GEOMETRIES`` (``_sweep``), on the same points and values,
    the pick held against the plain version: the sweep that
    ``blocking.py:spread3d_cost`` was fitted to.  3D, N = 256^3 (grid
    384^3), m = 4, sigma = 1.5, BKB FastApproximation, uniform points, each
    dtype at its main-path Np and at 16,777,216.  One JSON line a dtype and
    Np.

    With ``against`` (the path of another ``spread_3d.cu``, e.g. an
    earlier commit's), no sweep: that source and the shipped one, each
    built for M = 4 alone, as raw launches of each C of ``nchans``
    transforms in turns (in order, then reversed; CUDA events, median of
    ``reps`` after one warm-up) at the pick, both held against the plain
    version of the first and last transform, beside the grid's zeroing
    (inside each launch's time) and the points a block.  The ptxas lines of
    both builds' instantiations come first."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops.kernels import build

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    if against is not None:
        texts = {"shipped": _m_only(_inlined_source("spread_3d")),
                 "against": _m_only(_inlined_source("spread_3d", Path(against).read_text()))}
        libs = _build_all("spread3d_against_", texts)
        for k in libs:
            print(f"ptxas {k}: {_ptxas_lines(_probe_log(f'spread3d_against_{k}'))}", flush=True)
    else:
        libs = {"shipped": build.load()}
        print(f"ptxas: {_registers(build.PTXAS_LOG, 'spread_3d_(?:shared_)?kernel')}", flush=True)
    keys = list(libs)
    for name in dtypes:
        plan0 = nufft.PlanNUFFT(np.dtype(name), SHAPES[3], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        tol = 1e-5 if plan0.real_dtype == torch.float32 else 1e-12
        dims = [g for g in dict.fromkeys((plan0.block_dims,) + SPREAD3D_GEOMETRIES)
                if all(n % b == 0 for n, b in zip(plan0.shape_over, g))]
        for np_ in nps or (MAIN_NP[name], 16_777_216):
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((3, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            if against is None:
                vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
                _checked_pick(libs["shipped"], plan0, pts, vp, tol)
                sweep = _sweep(libs["shipped"], plan0, pts, vp, dims)
                print(json.dumps({"probe": "spread3d", "card": card, "dtype": name, "np": np_,
                                  "chosen": list(plan0.block_dims),
                                  "geometries_ms": {"x".join(map(str, g)): t
                                                    for g, t in sweep.items()}}), flush=True)
                continue
            plan = nufft.set_points(plan0, pts)
            for C in nchans:
                vp = torch.randn((C, np_), generator=gen, device=dev, dtype=plan0.dtype)
                vals = vp[:, plan.sort_perm].contiguous()
                ends = _plain_ends(plan, vp)
                times, errs = {k: [] for k in keys}, {}
                for order in (keys, keys[::-1]):
                    for k in order:
                        ms_, got = cuda_time_ms(lambda lib=libs[k]: _raw_spread(lib, plan, vals),
                                                reps=reps)
                        times[k].append(ms_)
                        errs[k] = max(errs.get(k, 0.0), _ends_err(got, ends))
                        if not errs[k] <= tol:
                            raise AssertionError(f"spread3d {k} {name} {np_} C={C}: rel L2 "
                                                 f"{errs[k]:.3e} vs plain")
                        del got
                zero_ms, _ = cuda_time_ms(lambda: torch.zeros((C,) + plan.shape_over,
                                                              dtype=plan.dtype, device=dev),
                                          reps=reps)
                ms = {k: statistics.median(t) for k, t in times.items()}
                print(json.dumps({"probe": "spread3d_against", "card": card, "dtype": name,
                                  "np": np_, "nchan": C, "block_dims": list(plan.block_dims),
                                  "points_a_block": _points_a_block(plan), "ms": ms,
                                  "runs_ms": times, "zero_ms": zero_ms,
                                  "shipped_over_against": ms["shipped"] / ms["against"],
                                  "rel_l2": errs}), flush=True)
                del vp, vals, ends
                torch.cuda.empty_cache()
            del plan, pts
            torch.cuda.empty_cache()


#: Copies of csrc/spread_3d.cu with one phase taken out, for
#: ``--spread3d-parts``: each maps a line of the source (spread_mma.cuh
#: written in place of its include) to its replacement, in both kernels
#: where both hold it (the flush is one function of both).  In the
#: one-transform kernel "no_taps" writes a number from the tap's index in
#: place of each tap (no Horner chains, no copied tap read), "no_dense"
#: leaves out the build of the dense operands (the k-steps read the stale
#: buffer), "no_values" the values' copies; "one_buffer" stages into one
#: buffer (the copies still run under the k-steps, the build after every
#: warp's), "no_overlap" also waits for the copies before the k-steps: the
#: batches' phases one after another, as before the pipeline.
#: Their grids are wrong; only their times and registers are read.  Without
#: the flush the compiler drops the accumulators too (40 registers against
#: 128), so "no_flush" times neither; "flush_sum" keeps them live.
SPREAD3D_PARTS = {
    "no_mma": {"mma_f64(acc[c][r], a[r], b);": "acc[c][r][0] += a[r][0] * b[0];",
               "mma_f64(acc[c][r], a, b);": "acc[c][r][0] += a[0] * b[0];"},
    "no_dense": {"      build(nxt, s_dense + buf * dense * kStride);\n": "",
                 "for (int e = warp; e < dense; e += nwarps) {":
                 "for (int e = warp; e < 0; e += nwarps) {"},
    "no_taps": {"for (int u = 0; u < kTaps; ++u) w[u] = s_f[(d * S + t0 + u) * kBatch + p];":
                "for (int u = 0; u < kTaps; ++u) w[u] = T(t0 + u + 1);",
                "for (int u = 0; u < kTaps; ++u) w[u] = cs[(ncoef - 1) * S + t0 + u];":
                "for (int u = 0; u < kTaps; ++u) w[u] = T(t0 + u + 1);",
                "            for (int c = ncoef - 2; c >= 0; --c)\n":
                "            for (int c = ncoef - 2; c < -1; --c)\n",
                "for (int e = warp; e < 3 * S; e += nwarps) {":
                "for (int e = warp; e < 0; e += nwarps) {"},
    # The values' global reads: no copy (the build reads what the buffer
    # holds), and in the shared kernel each point's value a number from its
    # index.
    "no_values": {"      if (d == 0) nufft::cp_async<sizeof(V)>(s_v + q, vrow + j);":
                  "      if (d == 0 && j < 0) nufft::cp_async<sizeof(V)>(s_v + q, vrow + j);",
                  "      if (p < nb) v = vals[(long long)(c0 + c) * np + p0 + p];":
                  "      if (p < nb) v.c[0] = T(p + 1);"},
    "one_buffer": {"  return spread_smem_bytes<T, NCOMP>(m, ncoef, b0, b1, b2, 2) <= budget ? 2 : 1;":
                   "  return 1;"},
    "no_overlap": {"  return spread_smem_bytes<T, NCOMP>(m, ncoef, b0, b1, b2, 2) <= budget ? 2 : 1;":
                   "  return 1;",
                   "    if (more) issue(nxt);  // lands while this batch's k-steps run\n":
                   "    if (more) issue(nxt);\n    nufft::cp_async_wait_all();\n"},
    "no_flush": {"    int oz, int n0, int n1, int n2) {\n  // Flush.":
                 "    int oz, int n0, int n1, int n2) {\n  return;\n  // Flush."},
    # The flush's complex64 / complex128 reductions as plain stores, and as
    # no write at all (a store under a condition that never holds).
    "flush_stores": {"  red_v2(p, float(re), float(im));":
                     "  *reinterpret_cast<float2*>(p) = make_float2(float(re), float(im));",
                     "  atomicAdd(p, re);\n  atomicAdd(p + 1, im);": "  p[0] = re;\n  p[1] = im;"},
    # The accumulators kept live by one conditional write of their sum, in
    # place of the flush's code.
    "flush_sum": {"    int oz, int n0, int n1, int n2) {\n  // Flush.":
                  "    int oz, int n0, int n1, int n2) {\n  {\n    double sum = 0.0;\n"
                  "#pragma unroll\n    for (int c = 0; c < kColTiles; ++c)\n"
                  "#pragma unroll\n      for (int r = 0; r < kRowTiles; ++r)\n"
                  "#pragma unroll\n        for (int e = 0; e < 2 * kHalves; ++e) sum += acc[c][r][e];\n"
                  "    if (sum == 1.25e-300) gch[t4] = T(sum);\n    return;\n  }\n  // Flush."},
    "flush_no_write": {"  red_v2(p, float(re), float(im));":
                       "  if (re == 1.25e-300) p[0] = float(im);",
                       "  atomicAdd(p, re);\n  atomicAdd(p + 1, im);":
                       "  if (re == 1.25e-300) p[0] = im;"},
}


def fit_spread2d(samples):
    """The 2D cost model's constants for one value type from the sweep:
    ``samples`` of (block dims, m, ncomp, Np, grid cells, seconds).  Each
    time is modelled as the sum of ``blocking.spread2d_counts`` (per cell,
    times the grid's cells) times a constant, fitted by non-negative least
    squares on relative errors.  Returns (constants, mean relative error)."""
    from scipy.optimize import nnls

    from nonuniformffts_tpu_torch import blocking

    rows = []
    for dims, m, ncomp, np_, cells, t in samples:
        counts = blocking.spread2d_counts(dims, m, ncomp, np_ / cells)
        rows.append([c * cells / t for c in counts])
    rows = np.array(rows)
    consts, _ = nnls(rows, np.ones(len(rows)))
    return tuple(float(c) for c in consts), float(np.mean(np.abs(rows @ consts - 1.0)))


def probe_spread2d(seed: int, dtypes, nps) -> None:
    """The 2D spread kernel at the chooser's pick and at
    ``SPREAD2D_GEOMETRIES`` (``_sweep``) at the main path's two densities
    (``SPREAD2D_FIT_NP``, or ``nps``), the pick held against the plain
    version, and the cost model fitted to the sweep (``fit_spread2d``) with
    the pick it makes.  2D, N = 4096^2 (grid 6144^2), m = 4, sigma = 1.5,
    BKB FastApproximation, uniform points.  One JSON line a dtype."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import nvidia_smi_line
    from nonuniformffts_tpu_torch import blocking
    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    lib = build.load()
    print(f"ptxas: {_registers(build.PTXAS_LOG, 'spread_2d_kernel')}", flush=True)
    for name in dtypes:
        plan0 = nufft.PlanNUFFT(np.dtype(name), SHAPES[2], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        _, sb, ncomp = VALUE_TYPES[plan0.dtype]
        cells = math.prod(plan0.shape_over)
        dims = [g for g in dict.fromkeys((plan0.block_dims,) + SPREAD2D_GEOMETRIES)
                if all(n % b == 0 for n, b in zip(plan0.shape_over, g))]
        samples, sweep = [], {}
        for np_ in nps or SPREAD2D_FIT_NP:
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((2, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
            _checked_pick(lib, plan0, pts, vp, 1e-5 if sb == 4 else 1e-12)
            times = _sweep(lib, plan0, pts, vp, dims)
            sweep[np_] = {"x".join(map(str, g)): t for g, t in times.items()}
            samples += [(g, 4, ncomp, np_, cells, 1e-3 * t) for g, t in times.items()]
        consts, mean_err = fit_spread2d(samples)
        saved = blocking.SPREAD2D_COST[(sb, ncomp)]
        blocking.SPREAD2D_COST[(sb, ncomp)] = consts
        pick = blocking.choose_geometry(plan0.shape_over, 4, sb, ncomp)
        blocking.SPREAD2D_COST[(sb, ncomp)] = saved
        print(json.dumps({"probe": "spread2d", "card": card, "dtype": name,
                          "geometries_ms": sweep, "fit": consts,
                          "fit_mean_rel_err": mean_err, "fit_pick": list(pick),
                          "shipped_pick": list(plan0.block_dims)}), flush=True)


#: Copies of csrc/spread_2d.cu with one phase taken out, for
#: ``--spread2d-parts``: each maps a line of the source (spread_mma.cuh
#: written in place of its include) to its replacement.  Their grids are
#: wrong; only their times are read.
SPREAD2D_PARTS = {
    "no_mma": {"nufft::mma_f64(acc[c][r], a[r], b);": "acc[c][r][0] += a[r][0] * b[0];"},
    # Every tap a number from z in place of Horner's rule; the staging
    # stores stay.
    "no_taps": {"tap_chunk<S, V>(wtaps, cs_d, ncoef, z, np, j, d, t0, w);":
                "for (int v = 0; v < V; ++v) w[v] = z + T(t0 + v);"},
    # No staging stores, and none of the erasing ones.
    "no_stores": {"col[row * kStride] = double(w[v]) * scale[k];":
                  "{ if (w[v] == T(1.25e-30)) col[row * kStride] = double(w[v]) * scale[k]; }",
                  "col[row * kStride] = 0.0;": "if (row == -7) col[row * kStride] = 0.0;"},
    # The flush's reductions as writes under a condition that never holds.
    "no_flush_write": {"  red_v2(p, float(re), float(im));": "  if (re == 1.25e-300) p[0] = float(im);",
                       "  atomicAdd(p, re);\n  atomicAdd(p + 1, im);":
                       "  if (re == 1.25e-300) p[0] = im;",
                       "nufft::red_v2(p0, float(d0), float(d1));":
                       "if (d0 == 1.25e-300) p0[0] = T(d1);",
                       "if (gy[c][0] >= 0 && d0 != 0.0) atomicAdd(p0, T(d0));":
                       "if (d0 == 1.25e-300) p0[0] = T(d0);",
                       "if (gy[c][1] >= 0 && d1 != 0.0) atomicAdd(line + gy[c][1], T(d1));":
                       "if (d1 == 1.25e-300) line[0] = T(d1);"},
}


def _inlined_source(stem: str, src: str = None) -> str:
    """``csrc/<stem>.cu`` (or the source text ``src``) with
    ``spread_mma.cuh`` written in place of its include, so that a probe can
    edit the header's code too."""
    from nonuniformffts_tpu_torch.ops.kernels import build

    if src is None:
        src = (build.CSRC_DIR / f"{stem}.cu").read_text()
    header = (build.CSRC_DIR / "spread_mma.cuh").read_text().replace("#pragma once\n", "")
    return src.replace('#include "spread_mma.cuh"\n', header)


def _m_only(text: str, ms=(4,)) -> str:
    """A kernel source instantiated for the M of ``ms`` alone (M = 4 by
    default: a quick build)."""
    anchor = '#include "window.cuh"\n'
    cases = " ".join(f"CASE({m})" for m in ms)
    return text.replace(anchor, anchor + "#undef NUFFT_FOR_EACH_M\n"
                        f"#define NUFFT_FOR_EACH_M(CASE) {cases}\n", 1)


#: Copies of csrc/interp_3d.cu with one phase taken out, for
#: ``--interp3d-parts``: each maps a line of the source to its replacement.
#: Their values are wrong; only their times and registers are read.
INTERP3D_PARTS = {
    "no_stage": {"for (int l = l0; l < w.pd2; l += 32) cp_async":
                 "for (int l = l0; l < 0; l += 32) cp_async"},
    "no_taps": {"s_tap[row * kBatch + p] = tap<M, T, TAPS>(cs, ncoef, "
                "fracs[d * np + pb + p], wtaps, np,":
                "s_tap[row * kBatch + p] = T(0.1) * T(d + 1);\n"
                "      (void)tap<M, T, TAPS>(cs, ncoef, T(0), wtaps, np,"},
    "no_loads": {"[&](int a, int k) { return base[a * w.plane + k * L::kRows * w.pitch]; });":
                 "[&](int a, int k) { V v; v.c[0] = T(a + k); return v; });"},
    "no_reduce": {"for (int off = L::kPerPoint / 2; off >= 1; off /= 2)":
                  "for (int off = 0; off >= 1; off /= 2)"},
    "no_out": {"            *dst = res;": "            if (res.c[0] == T(1.25e-30)) *dst = res;"},
}
INTERP3D_PARTS["no_cells"] = {
    "            const int lx = cells[pb + p] - ox;": "            const int lx = (pb + p) & 7;",
    "            s_pt[kBatch + p] = lx * w.plane + (cells[np + pb + p] - oy) * w.pitch +\n"
    "                               (cells[2 * np + pb + p] - oz);":
    "            s_pt[kBatch + p] = lx * w.plane + ((p >> 3) & 7) * w.pitch + (p & 7);"}
INTERP3D_PARTS["no_contract"] = {
    "          contract_batch<T, NCOMP, L>(nb, s_res, [&](int p) {\n"
    "            if (p >= nb || ze >= S) return V{};":
    "          if (nb < 0) contract_batch<T, NCOMP, L>(nb, s_res, [&](int p) {\n"
    "            if (p >= nb || ze >= S) return V{};"}
# All of the window's copy, the taps and the window's loads out at once: the
# CTAs' skeleton; then also without the output and the cells' loads.
INTERP3D_PARTS["skeleton"] = {k: v for part in ("no_stage", "no_taps", "no_loads")
                              for k, v in INTERP3D_PARTS[part].items()}
INTERP3D_PARTS["skeleton_no_out"] = {**INTERP3D_PARTS["skeleton"], **INTERP3D_PARTS["no_out"]}
INTERP3D_PARTS["skeleton_no_cells"] = {**INTERP3D_PARTS["skeleton_no_out"],
                                       **INTERP3D_PARTS["no_cells"]}


# A 2D interpolation kernel tried in place of the per-point kernel of
# csrc/interp_2d.cu, kept for --interp2d, which times the two in turns: a CTA
# covers a run of consecutive blocks of one x row of blocks (pstarts); each
# sub-run of blocks whose padded window holds at most kStageCells cells a
# point is staged in shared memory by cp.async (in x-slab passes above
# 227 KB), its points dealt round robin over the banks of a wavefront by
# shared-memory bucket counts and contracted a thread a point from the
# window; the points of sparser sub-runs are read from global memory.  Its C
# interface adds pstarts and the block dims to the shipped kernel's.  Built
# by --interp2d into build/chip_probe/.
_STAGED_INTERP_2D_SRC = r"""
#include <cstdint>

#include "window.cuh"

namespace {

constexpr int kThreads = 256;
// A sub-run is staged when its padded window holds at most this many cells
// a point.
constexpr int kStageCells = 8;
constexpr int kStageRun = 256;    // most y cells of a staged sub-run's blocks
constexpr int kRunPoints = 1024;  // points of a CTA's staged run at the mean density
constexpr int kChunk = 1024;      // points of a staged sub-run ordered at a time

constexpr int kMaxGroup = 64;  // most spatial blocks one CTA covers
constexpr size_t kMaxSmem = 232448;

// y taps of a coefficient row: 2M rounded up to a power of two (at least 4).
__host__ __device__ constexpr int y_span(int m) {
  return 2 * m <= 4 ? 4 : 2 * m <= 8 ? 8 : 2 * m <= 16 ? 16 : 32;
}

// The staged window of a sub-run of `sub` blocks: cells, x rows pd1 cells
// apart; `rows` x rows staged a pass, `passes` passes; `head` bytes of
// tables before it.
struct Window {
  int pd0, pd1, rows, passes;
  size_t head, smem;
};

template <int M, typename T, int NCOMP>
__host__ __device__ inline Window window_of(int ncoef, int b0, int b1, int sub) {
  Window w;
  w.pd0 = b0 + 2 * M - 1;
  w.pd1 = sub * b1 + 2 * M - 1;
  // The (ncoef, 2, span) coefficient table, the bucket counts, a chunk's
  // order, window offsets and bucket ranks, the CTA's blocks' point ranges.
  constexpr int kBuckets = 128 / int(sizeof(T) * NCOMP);
  const size_t head = sizeof(T) * ncoef * 2 * y_span(M) +
                      sizeof(int) * (kBuckets + 3 * kChunk + kMaxGroup + 1);
  w.head = (head + 15) / 16 * 16;
  const size_t row_bytes = sizeof(T) * NCOMP * (size_t)w.pd1;
  const long long fit = w.head < kMaxSmem ? (long long)((kMaxSmem - w.head) / row_bytes) : 0;
  w.passes = fit >= 1 ? (int)((w.pd0 + fit - 1) / fit) : 0;
  w.rows = w.passes ? (w.pd0 + w.passes - 1) / w.passes : 0;
  w.smem = w.head + row_bytes * w.rows;
  return w;
}

// Blocks of a staged sub-run: at most kStageRun y cells, at least one block.
__host__ __device__ inline int sub_of(int group, int b1) {
  const int fit = kStageRun / b1 > 1 ? kStageRun / b1 : 1;
  return group < fit ? group : fit;
}

// Blocks a CTA covers, at most kMaxGroup and a row of blocks: where a full sub-run at the mean density
// is staged, whole sub-runs of about kRunPoints points; else about a CTA's
// threads' worth of points, each thread's one point read from global
// memory.
__host__ inline int group_of(long long np, int m, int n0, int n1, int b0, int b1) {
  const long long nb1 = n1 / b1, mean = np / ((n0 / b0) * nb1);
  const long long cap = nb1 < kMaxGroup ? nb1 : kMaxGroup;
  const long long fit = sub_of((int)cap, b1);
  long long g;
  if (mean * fit * kStageCells >= (long long)(b0 + 2 * m - 1) * (fit * b1 + 2 * m - 1)) {
    g = kRunPoints / (mean + 1);
    g = g > fit ? g / fit * fit : fit;
  } else {
    g = kThreads / (mean + 1);
  }
  return (int)(g < 1 ? 1 : g > cap ? cap : g);
}

// Whether a sub-run of `points` points whose window has pd0 x pd1 cells
// is staged.
__device__ __forceinline__ bool staged_run(int points, int pd0, int pd1) {
  return points > 0 && (long long)points * kStageCells >= (long long)pd0 * pd1;
}

// window.cuh's (copies of its own beside them were ambiguous by
// argument-dependent lookup).
using nufft::cp_async;
using nufft::cp_async_commit;
using nufft::cp_async_wait_all;
using nufft::mod_index;

// Both dims' 2M taps of sorted point j: from wtaps, or by Horner's rule on
// the coefficient table cs, (ncoef, 2, y_span(M)).
template <int M, typename T, bool TAPS>
__device__ __forceinline__ void point_taps_2d(const T* cs, int ncoef, const T* __restrict__ fracs,
                                              const T* __restrict__ wtaps, long long np,
                                              long long j, T (&w)[2][2 * M]) {
  constexpr int S = 2 * M, kSpan = y_span(M);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    if constexpr (TAPS) {
#pragma unroll
      for (int t = 0; t < S; ++t) w[d][t] = wtaps[(d * S + t) * np + j];
    } else {
      nufft::horner_rows<S, T, 2 * kSpan>(cs + d * kSpan, ncoef, fracs[d * np + j], w[d]);
    }
  }
}

// One point's sum over x taps a with has_x(a): row by row, each row's y
// taps first (the first design's order), UNROLL rows at a time; at(a, b)
// reads cell (a, b) of the point's window.
template <int M, typename T, int NCOMP, int UNROLL, class HasX, class At>
__device__ __forceinline__ nufft::Value<T, NCOMP> point_sum(const T (&w)[2][2 * M], HasX has_x,
                                                            At at) {
  constexpr int S = 2 * M;
  nufft::Value<T, NCOMP> acc = {};
#pragma unroll UNROLL
  for (int a = 0; a < S; ++a) {
    if (!has_x(a)) continue;
    T r[NCOMP] = {};
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const nufft::Value<T, NCOMP> v = at(a, b);
#pragma unroll
      for (int n = 0; n < NCOMP; ++n) r[n] = nufft::fma_t(v.c[n], w[1][b], r[n]);
    }
#pragma unroll
    for (int n = 0; n < NCOMP; ++n) acc.c[n] = nufft::fma_t(r[n], w[0][a], acc.c[n]);
  }
  return acc;
}

// One CTA covers a run of at most `group` consecutive blocks of one x row
// of blocks, in sub-runs of at most `sub` blocks.  TAPS: the window's taps
// come in wtaps (window_weights.cu), else by Horner's rule.
template <int M, typename T, int NCOMP, bool TAPS>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    interp_2d_kernel(
    const nufft::Value<T, NCOMP>* __restrict__ grid,
    const int* __restrict__ cells, const T* __restrict__ fracs,
    const long long* __restrict__ perm, const int* __restrict__ pstarts,
    const T* __restrict__ coefs, const T* __restrict__ wtaps,
    nufft::Value<T, NCOMP>* __restrict__ out, long long np, int nchan,
    int ncoef, int n0, int n1, int b0, int b1, int group, double normfactor) {
  using V = nufft::Value<T, NCOMP>;
  constexpr int S = 2 * M, kSpan = y_span(M), kCol = 2 * kSpan;
  constexpr int kBuckets = 128 / int(sizeof(V));  // cells of a wavefront
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int nb1 = n1 / b1;
  const int runs = (nb1 + group - 1) / group;  // runs a row of blocks
  const int bx = blockIdx.x / runs;
  const int run = blockIdx.x - bx * runs;
  const int first = bx * nb1 + run * group;
  const int ng = min(group, nb1 - run * group);  // blocks of this CTA
  const int sub = sub_of(group, b1);
  const int nsub = (ng + sub - 1) / sub;  // sub-runs of this CTA

  const Window w = window_of<M, T, NCOMP>(ncoef, b0, b1, sub);
  T* cs = reinterpret_cast<T*>(smem_raw);              // (ncoef, 2, kSpan), zero past 2M
  int* s_cnt = reinterpret_cast<int*>(cs + kCol * ncoef);  // (kBuckets,)
  int* s_order = s_cnt + kBuckets;                     // (kChunk,): a chunk's points in order
  int* s_base = s_order + kChunk;                      // (kChunk,): window offsets
  int* s_rank = s_base + kChunk;                       // (kChunk,): bucket | rank << 8
  int* s_ps = s_rank + kChunk;                         // (ng + 1,): the blocks' point ranges
  V* win = reinterpret_cast<V*>(smem_raw + w.head);    // (rows, pd1)
  const int tid = threadIdx.x;
  for (int i = tid; i <= ng; i += blockDim.x) s_ps[i] = pstarts[first + i];
  for (int i = tid; i < kCol * ncoef; i += blockDim.x) {
    const int c = i / kCol, d = (i - c * kCol) / kSpan, t = i - c * kCol - d * kSpan;
    cs[i] = t < S ? coefs[(d * S + t) * ncoef + c] : T(0);
  }
  __syncthreads();
  const int q_begin = s_ps[0], q_end = s_ps[ng];
  if (q_begin == q_end) return;  // uniform across the CTA
  // Sub-run s: blocks [s sub, min((s + 1) sub, ng)), its window
  // pd0 x (blocks b1 + 2M - 1) cells.
  auto sub_blocks = [&](int s) { return min(sub, ng - s * sub); };
  auto sub_staged = [&](int s) {
    return staged_run(s_ps[s * sub + sub_blocks(s)] - s_ps[s * sub], w.pd0,
                      sub_blocks(s) * b1 + 2 * M - 1);
  };
  // Every thread reads the same table: the branches below are uniform.
  bool any_sparse = false;
  for (int s = 0; s < nsub; ++s)
    any_sparse = any_sparse || (!sub_staged(s) && s_ps[s * sub + sub_blocks(s)] > s_ps[s * sub]);

  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long area = (long long)n0 * n1;
  const T nf = T(normfactor);
  const int ox = bx * b0;

  // The points of sparse sub-runs, a thread a point, each point's window
  // read from global memory with periodic wrap.
  if (any_sparse) {
    for (int j = q_begin + tid; j < q_end; j += blockDim.x) {
      int lo = 0, hi = ng;  // j's block: the last one starting at or before j
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_ps[mid] <= j) lo = mid;
        else hi = mid;
      }
      if (sub_staged(lo / sub)) continue;
      T wt[2][S];
      point_taps_2d<M, T, TAPS>(cs, ncoef, fracs, wtaps, np, j, wt);
      const int cx = cells[j] - (M - 1), cy = cells[np + j] - (M - 1);
      int iy[S];
#pragma unroll
      for (int b = 0; b < S; ++b) iy[b] = nufft::wrap_index(cy + b, n1);
      const long long dest = perm[j];
      for (int c = 0; c < nchan; ++c) {
        const V* g = grid + c * area;
        const V acc = point_sum<M, T, NCOMP, 2>(
            wt, [](int) { return true; },
            [&](int a, int b) { return g[(long long)nufft::wrap_index(cx + a, n0) * n1 + iy[b]]; });
        V res;
#pragma unroll
        for (int n = 0; n < NCOMP; ++n) res.c[n] = acc.c[n] * nf;
        out[c * np + dest] = res;
      }
    }
  }

  // Staged sub-runs, one at a time.
  for (int s = 0; s < nsub; ++s) {
    if (!sub_staged(s)) continue;  // uniform
    const int p_begin = s_ps[s * sub], p_end = s_ps[s * sub + sub_blocks(s)];
    const int pd1 = sub_blocks(s) * b1 + 2 * M - 1;
    const int oy = (first - bx * nb1 + s * sub) * b1;
    // Staging lanes: rows of the window by sub-warps of pd1 lanes (as many
    // as fit in 32), a lane a y cell; a row longer than 32 cells takes a
    // warp.  Padded index i along a dim is grid node origin - (M - 1) + i,
    // wrapped (more than once where the grid is smaller than the window).
    const int rpw = pd1 <= 32 ? 32 / pd1 : 1;
    const int part = pd1 <= 32 ? lane / pd1 : 0;
    const int l0 = lane - part * (pd1 <= 32 ? pd1 : 0);
    for (int c = 0; c < nchan; ++c) {
      const V* g = grid + c * area;
      for (int pass = 0; pass < w.passes; ++pass) {
        const int x0 = pass * w.rows;
        const int nx = min(w.rows, w.pd0 - x0);
        __syncthreads();  // the last window and chunk are read
        // Copy x rows x0 .. x0 + nx of the window.
        if (part < rpw) {
          for (int i = warp * rpw + part; i < nx; i += nwarps * rpw) {
            const V* src = g + (long long)mod_index(ox - (M - 1) + x0 + i, n0) * n1;
            V* dst = win + (long long)i * pd1;
            for (int l = l0; l < pd1; l += 32)
              cp_async<sizeof(V)>(dst + l, src + mod_index(oy - (M - 1) + l, n1));
          }
        }
        cp_async_commit();

        for (int cb = p_begin; cb < p_end; cb += kChunk) {
          const int nc = min(kChunk, p_end - cb);
          if (cb > p_begin) __syncthreads();  // the last chunk is read
          for (int i = tid; i < kBuckets; i += blockDim.x) s_cnt[i] = 0;
          __syncthreads();
          // Each point's window offset (x0's row first), its bucket and its
          // rank there.
          for (int p = tid; p < nc; p += blockDim.x) {
            const long long j = cb + p;
            const int base = (cells[j] - ox - x0) * pd1 + (cells[np + j] - oy);
            const int r = base & (kBuckets - 1);
            s_base[p] = base;
            s_rank[p] = r | atomicAdd(&s_cnt[r], 1) << 8;
          }
          __syncthreads();
          // Round robin over the buckets: the point of rank k in bucket r
          // goes after every point of lower rank and the rank-k points of
          // lower buckets.
          for (int p = tid; p < nc; p += blockDim.x) {
            const int r = s_rank[p] & 255, k = s_rank[p] >> 8;
            int pos = 0;
#pragma unroll
            for (int q = 0; q < kBuckets; ++q) {
              const int n = s_cnt[q];
              pos += min(n, k) + (q < r && n > k);
            }
            s_order[pos] = p;
          }
          cp_async_wait_all();
          __syncthreads();
          for (int i = tid; i < nc; i += blockDim.x) {
            const int p = s_order[i];
            const long long j = cb + p;
            T wt[2][S];
            point_taps_2d<M, T, TAPS>(cs, ncoef, fracs, wtaps, np, j, wt);
            const V* base = win + s_base[p];
            const int lx = w.passes == 1 ? 0 : cells[j] - ox - x0;  // x row past x0
            const V acc = point_sum<M, T, NCOMP, S>(
                wt, [&](int a) { return w.passes == 1 || (unsigned)(lx + a) < (unsigned)nx; },
                [&](int a, int b) { return base[a * pd1 + b]; });
            V* dst = out + c * np + perm[j];
            V res;
            if (pass == 0) {
#pragma unroll
              for (int n = 0; n < NCOMP; ++n) res.c[n] = acc.c[n] * nf;
            } else {
              res = *dst;
#pragma unroll
              for (int n = 0; n < NCOMP; ++n) res.c[n] += acc.c[n] * nf;
            }
            *dst = res;
          }
        }
      }
    }
  }
}

template <int M, typename T, int NCOMP>
cudaError_t launch(const void* grid, const void* cells, const void* fracs,
                   const void* perm, const void* pstarts, const void* coefs,
                   const void* wtaps, void* out, long long np, int nchan,
                   int ncoef, int n0, int n1, int b0, int b1, double normfactor,
                   cudaStream_t stream) {
  const int group = group_of(np, M, n0, n1, b0, b1);
  const Window w = window_of<M, T, NCOMP>(ncoef, b0, b1, sub_of(group, b1));
  if (w.passes == 0) return cudaErrorInvalidValue;
  auto kernel = wtaps ? interp_2d_kernel<M, T, NCOMP, true>
                      : interp_2d_kernel<M, T, NCOMP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w.smem);
  if (err != cudaSuccess) return err;
  const int nb1 = n1 / b1;
  const unsigned ctas = (unsigned)((n0 / b0) * ((nb1 + group - 1) / group));
  kernel<<<ctas, kThreads, w.smem, stream>>>(
      static_cast<const nufft::Value<T, NCOMP>*>(grid),
      static_cast<const int*>(cells), static_cast<const T*>(fracs),
      static_cast<const long long*>(perm), static_cast<const int*>(pstarts),
      static_cast<const T*>(coefs), static_cast<const T*>(wtaps),
      static_cast<nufft::Value<T, NCOMP>*>(out), np, nchan, ncoef, n0, n1, b0, b1,
      group, normfactor);
  return cudaGetLastError();
}

template <typename T, int NCOMP>
int dispatch(const void* grid, const void* cells, const void* fracs,
             const void* perm, const void* pstarts, const void* coefs,
             const void* wtaps, void* out, long long np, int nchan, int m,
             int ncoef, int n0, int n1, int b0, int b1, double normfactor,
             void* stream) {
  if (np == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NUFFT_INTERP_CASE(MM)                                                  \
  case MM:                                                                     \
    return (int)launch<MM, T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs, \
                                     wtaps, out, np, nchan, ncoef, n0, n1, b0, \
                                     b1, normfactor, s);
  switch (m) {
    NUFFT_FOR_EACH_M(NUFFT_INTERP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NUFFT_INTERP_CASE
}

}  // namespace

// grid (nchan, n0, n1) values (complex: re, im interleaved); cells (2, np)
// int32 and fracs (2, np) T in bin-sorted order; perm (np,) int64, the
// original index of each sorted point; pstarts (nblocks + 1,) int32, block
// b's points being sorted positions [pstarts[b], pstarts[b + 1]) for blocks
// (b0, b1) numbered row-major; coefs (2, 2m, ncoef) T, or ncoef = 0 and no
// coefficients for a window other than kHorner, whose taps come in wtaps
// (2, 2m, np) T (window_weights.cu), null for kHorner; out (nchan, np)
// values in original point order.  T is float for *_f32, double for *_f64;
// normfactor is a double for both.  Launches on `stream`, does not
// synchronise, allocates nothing.
#define NUFFT_INTERP_ENTRY(NAME, T, NCOMP)                                    \
  extern "C" int NAME(const void* grid, const void* cells, const void* fracs, \
                      const void* perm, const void* pstarts,                  \
                      const void* coefs, const void* wtaps, void* out,        \
                      long long np, int nchan, int m, int ncoef, int n0,      \
                      int n1, int b0, int b1, double normfactor,              \
                      void* stream) {                                         \
    return dispatch<T, NCOMP>(grid, cells, fracs, perm, pstarts, coefs,       \
                              wtaps, out, np, nchan, m, ncoef, n0, n1, b0,    \
                              b1, normfactor, stream);                        \
  }

#if NUFFT_WANT(0)
NUFFT_INTERP_ENTRY(staged_interp_2d_f32, float, 2)
#endif
#if NUFFT_WANT(1)
NUFFT_INTERP_ENTRY(staged_interp_2d_f64, double, 2)
#endif
#if NUFFT_WANT(2)
NUFFT_INTERP_ENTRY(staged_interp_2d_real_f32, float, 1)
#endif
#if NUFFT_WANT(3)
NUFFT_INTERP_ENTRY(staged_interp_2d_real_f64, double, 1)
#endif
"""


#: Copies of csrc/spread_1d.cu with one phase taken out, for
#: ``--spread1d-parts``: each maps a line of the source to its replacement.
#: Their grids are wrong; only their times are read.
SPREAD1D_PARTS = {
    # Every tap a number from the fraction in place of Horner's rule.
    "no_taps": {"nufft::horner_rows<S>(cs, ncoef, f_cur, w);":
                "for (int t = 0; t < S; ++t) w[t] = f_cur + T(t);"},
    # The points' fractions and values made up in place of read.
    "no_loads": {"      f = fracs[j];\n      v = vrow[perm[j]];":
                 "      f = T(0.25);\n      v.c[0] = T(0.5);",
                 "        f = fracs[j + 1];\n        v = vrow[q_next];":
                 "        f = T(j & 7);\n        v.c[0] = f;"},
    # No lane walks its cell's points (the first point's loads stay).
    "no_walk": {"for (; j < j_end; ++j) {": "for (; j < j_end && j < 0; ++j) {"},
    # The rounds' rotation by shuffles.
    "no_shuffle": {"__shfl_sync(0xffffffffu, acc[t][k], (lane - t) & 31)": "acc[t][k]"},
    # The flush's stores and reductions as writes under a condition that
    # never holds.
    "no_flush_write": {
        "    *reinterpret_cast<nufft::Value<T, NCOMP>*>(dst) = v;":
        "    if (v.c[0] == T(1.25e-30)) *reinterpret_cast<nufft::Value<T, NCOMP>*>(dst) = v;",
        "    nufft::add_complex(dst, sum[0], sum[1]);":
        "    if (sum[0] == 1.25e-300) dst[0] = T(sum[1]);",
        "    atomicAdd(dst, T(sum[0]));": "    if (sum[0] == 1.25e-300) dst[0] = T(sum[0]);"},
}

#: Copies of csrc/interp_2d.cu with one phase taken out, for
#: ``--interp2d-parts``.  Their values are wrong; only their times are read.
_OUT = "      out[c * np + dest] = res;"
INTERP2D_PARTS = {
    # Every tap a number from the fraction in place of Horner's rule.
    "no_taps": {"    nufft::horner_rows<S>(cs, ncoef, fracs[j], wx);\n"
                "    nufft::horner_rows<S>(cs + kPitch * ncoef, ncoef, fracs[np + j], wy);":
                "    for (int t = 0; t < S; ++t) {\n"
                "      wx[t] = fracs[j] + T(t);\n"
                "      wy[t] = fracs[np + j] * T(t + 1);\n"
                "    }"},
    # The window's cells made up in place of read (whole chunks and cell by
    # cell), with their addresses.
    "no_loads": {"            for (int q = 0; q < kChunks; ++q) ch[b][q] = row[q];":
                 "            for (int q = 0; q < kChunks; ++q) {\n"
                 "              ch[b][q] = Chunk<V, kPer>{};\n"
                 "              ch[b][q].v[0].c[0] = T(y0 + q) + T(row == nullptr);\n"
                 "            }",
                 "          const V val = row[iy[b]];":
                 "          V val = {};\n          val.c[0] = T(iy[b]);"},
    # The results written under a condition that never holds.
    "no_out": {_OUT: _OUT.replace("out[", "if (res.c[0] == T(1.25e-30)) out[")},
    # Each result at its sorted position, not scattered to perm[j].
    "out_sorted": {_OUT: "      out[c * np + j] = res;"},
    # The point state made up from j in place of read, as the per-point
    # kernel's no_point_state.
    "no_point_state": {
        "fracs[j], wx);": "T(j & 7) * T(0.125), wx);",
        "fracs[np + j], wy);": "T(j & 15) * T(0.0625), wy);",
        "  const int cx = cells[j] - (M - 1);\n  const int cy = cells[np + j] - (M - 1);":
        "  const long long lin = j * ((long long)n0 * n1) / np;\n"
        "  const int cx = int(lin / n1) - (M - 1);\n"
        "  const int cy = int(lin % n1) - (M - 1);",
        "  const long long dest = perm[j];":
        "  const long long dest = (long long)(((unsigned long long)((unsigned)j * 2654435761u)"
        " * (unsigned long long)np) >> 32);"},
}
#: The first design of csrc/interp_2d.cu, as that file keeps it: its
#: instantiations all launch ``interp_2d_point_kernel`` (``chunked_rows``
#: off), for ``--interp2d``.
FIRST_DESIGN_2D = {"  return (rows_mask(scalar_bytes, ncomp) >> m) & 1u;": "  return false;"}
#: The designs ``--interp2d`` times against the shipped kernel: edits of it.
INTERP2D_DESIGNS = {"point": FIRST_DESIGN_2D}

#: Copies of the first design (``FIRST_DESIGN_2D``) with one phase taken
#: out or changed, for ``--interp2d-parts``, beside it unedited
#: (``point``).  The first four are that kernel's first parts; the last
#: three place what those left unplaced.  Only their times are read.
_POINT_X_LOOP = """#pragma unroll 1
    for (int a = 0; a < S; ++a) {
      T wx;
      if constexpr (TAPS) {
        wx = wtaps[a * np + j];
      } else {
        wx = nufft::horner_tap(cs + a * ncoef, ncoef, T(2) * fx - T(1));
      }
"""
_POINT_NF = "  const T nf = T(normfactor);\n\n  for (int c = 0; c < nchan; ++c) {\n"
_POINT_X_TAPS = """  T wxs[S];
  if constexpr (TAPS) {
#pragma unroll
    for (int t = 0; t < S; ++t) wxs[t] = wtaps[t * np + j];
  } else {
    nufft::horner_taps<S>(cs, ncoef, fx, wxs);
  }
"""
_POINT_UNROLLED = {
    _POINT_NF: _POINT_NF.replace("\n\n", "\n" + _POINT_X_TAPS + "\n", 1),
    _POINT_X_LOOP:
    "#pragma unroll\n    for (int a = 0; a < S; ++a) {\n      const T wx = wxs[a];\n",
}
_POINT_OUT = "    out[c * np + dest] = res;\n  }\n}\n\n// This design"
POINT_INTERP2D_PARTS = {
    "point": FIRST_DESIGN_2D,
    # Every tap a number in place of Horner's rule.
    "point_no_taps": {
        **FIRST_DESIGN_2D,
        "nufft::horner_taps<S>(cs + S * ncoef, ncoef, fracs[np + j], wy);":
        "for (int t = 0; t < S; ++t) wy[t] = T(0.1) * T(t + 1);",
        "wx = nufft::horner_tap(cs + a * ncoef, ncoef, T(2) * fx - T(1));": "wx = fx + T(a);"},
    # The window's cells made up in place of read from the grid.
    "point_no_loads": {
        **FIRST_DESIGN_2D,
        "const nufft::Value<T, NCOMP> val = row[iy[b]];":
        "nufft::Value<T, NCOMP> val = {};\n        val.c[0] = T(iy[b]);"},
    # The result written under a condition that never holds.
    "point_no_out": {
        **FIRST_DESIGN_2D,
        _POINT_OUT: _POINT_OUT.replace("out[", "if (res.c[0] == T(1.25e-30)) out[", 1)},
    # Each result at its sorted position, not scattered to perm[j].
    "point_out_sorted": {
        **FIRST_DESIGN_2D,
        _POINT_OUT: _POINT_OUT.replace("out[c * np + dest]", "out[c * np + j]", 1)},
    # The point state made up from j in place of read: cells walking the
    # grid row-major at the points' density, fractions from j's low bits,
    # the destination a multiplicative hash of j over [0, np) (a scatter
    # like perm's, with no load).
    "point_no_point_state": {
        **FIRST_DESIGN_2D,
        "fracs[np + j], wy);": "T(j & 15) * T(0.0625), wy);",
        "  const int cx = cells[j] - (M - 1);\n  const int cy = cells[np + j] - (M - 1);":
        "  const long long lin = j * ((long long)n0 * n1) / np;\n"
        "  const int cx = int(lin / n1) - (M - 1);\n"
        "  const int cy = int(lin % n1) - (M - 1);",
        "  const T fx = fracs[j];": "  const T fx = T(j & 7) * T(0.125);",
        "  const long long dest = perm[j];":
        "  const long long dest = (long long)(((unsigned long long)((unsigned)j * 2654435761u)"
        " * (unsigned long long)np) >> 32);"},
    # The x loop unrolled, with the 2M x taps computed before it.
    "point_x_unrolled": {**FIRST_DESIGN_2D, **_POINT_UNROLLED},
    # As x_unrolled, and both dimensions' taps by horner_rows on a
    # coefficient-major table in shared memory (the 2M chains together).
    "point_rows_taps": {
        **FIRST_DESIGN_2D,
        **_POINT_UNROLLED,
        "  T* cs = reinterpret_cast<T*>(smem_raw);  // (2, S, ncoef)\n"
        "  for (int i = threadIdx.x; i < 2 * S * ncoef; i += blockDim.x)\n"
        "    cs[i] = coefs[i];":
        "  T* cs = reinterpret_cast<T*>(smem_raw);  // (2, ncoef, row_pitch)\n"
        "  coefficient_rows<2, S>(coefs, ncoef, cs);",
        "nufft::horner_taps<S>(cs + S * ncoef, ncoef, fracs[np + j], wy);":
        "nufft::horner_rows<S>(cs + nufft::row_pitch<S, T>() * ncoef, ncoef, fracs[np + j], wy);",
        _POINT_X_TAPS: _POINT_X_TAPS.replace("nufft::horner_taps<S>(cs, ncoef, fx, wxs);",
                                             "nufft::horner_rows<S>(cs, ncoef, fx, wxs);"),
        "const size_t smem = sizeof(T) * 2 * 2 * M * (size_t)ncoef;":
        "const size_t smem = sizeof(T) * 2 * (size_t)nufft::row_pitch<2 * M, T>() * ncoef;"},
}

#: Copies of csrc/interp_1d.cu with one phase of its staged path (the one
#: outputs above ``INTERP1D_GATHER_BYTES`` take) taken out, for
#: ``--interp1d-parts``.  Their values are wrong; only their times are read.
_STORE = "        out[(c0 + c) * np + j] = res;"
INTERP1D_PARTS = {
    # The sorted results written under a condition that never holds.
    "no_out": {_STORE: _STORE.replace("out[", "if (res.c[0] == T(1.25e-30)) out[")},
    # No gather into the caller's order.
    "no_gather": {"  gather_kernel<V><<<": "  if (np < 0) gather_kernel<V><<<"},
    # The window's cells made up in place of read (staged and global).
    "no_loads": {"{ return sw[t]; }": "{ V v = {}; v.c[0] = T(cx + t); return v; }",
                 "return g[nufft::wrap_index(cx - (M - 1) + t, n0)];":
                 "V v = {};\n            v.c[0] = T(cx + t);\n            return v;"},
    # Every tap a number from the fraction in place of Horner's rule (both
    # paths).
    "no_taps": {"nufft::horner_rows<S>(cs, ncoef, fracs[j], w);":
                "for (int t = 0; t < S; ++t) w[t] = fracs[j] + T(t);"},
    # No window staged: only the copy into shared memory taken out (the
    # points read the uninitialised window).
    "no_stage": {"          cp_async<16>(dst, row + gc);": "          if (gc < -n0) cp_async<16>(dst, row + gc);"},
}
def _edited_sources(stem: str, parts, ms=(4,)) -> dict:
    """``csrc/<stem>.cu`` with ``spread_mma.cuh`` written in place of its
    include (``_inlined_source``), for the M of ``ms`` alone, as
    ``shipped``, and a copy for each entry of ``parts`` (a ``*_PARTS``
    table) with its lines replaced, under the entry's name."""
    src = _m_only(_inlined_source(stem), ms)
    texts = {"shipped": src}
    for name, edits in parts.items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in {stem}.cu")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def _build_all(prefix: str, texts) -> dict:
    """``{name: source text}`` built at once into ``build/chip_probe/`` as
    ``<prefix><name>``; returns ``{name: loaded library}``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(texts)) as pool:
        futures = {k: pool.submit(_probe_library, prefix + k, text) for k, text in texts.items()}
        return {k: f.result() for k, f in futures.items()}


def _resident_ctas(registers: int, threads: int = 256) -> int:
    """CTAs of ``threads`` an H100 SM holds at ``registers`` a thread (65,536
    registers, allocated a warp at a time in units of 256, at most 64 warps
    and 32 CTAs), shared memory aside.  (The 1D interpolation's staged
    kernel runs CTAs of 128: it holds twice as many.)"""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def _inverse(perm, how: str = "index_put"):
    """The sorted position of each point, int32, from ``perm``: as
    ``set_points`` makes it (``blocked.interp1d_inverse``, ``index_put``) or
    by ``scatter_``."""
    import torch

    src = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    inv = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    if how == "index_put":
        inv[perm] = src
    else:
        inv.scatter_(0, perm, src)
    return inv


#: Point counts of ``--interp1d-sweep`` (the main path's 1D grid, 2^20
#: modes, sigma = 1.5): from the main path's 1M to its 10M.
INTERP1D_SWEEP_NP = (1_000_000, 1_500_000, 2_000_000, 3_000_000, 4_000_000, 5_000_000,
                     6_000_000, 8_000_000, 10_000_000)


def probe_interp1d_sweep(seed: int, dtypes, nps, reps: int) -> None:
    """The shipped 1D interpolation's two paths on the same points, both
    forced whatever ``common.interp1d_gathers`` would choose: the point path
    (results scattered to ``perm[j]``) and the staged path (stored sorted,
    then gathered through the inverse permutation), raw launches in turns
    (scatter, gather, gather, scatter, twice; CUDA events, median of
    ``reps`` after one warm-up), one and two transforms, the four dtypes, at
    each point count of ``nps`` (default ``INTERP1D_SWEEP_NP``), M = 4,
    BKB Fast, uniform points.  The two outputs must agree to the kernel
    tolerance (both sum in the same order).  One JSON line a dtype, C and
    Np, with the output's bytes, where ``INTERP1D_GATHER_BYTES`` sets the
    wrapper's choice, and the time of the inverse permutation that the
    gather reads and ``set_points`` makes (``index_put`` as it does, and
    ``scatter_``; the later of two timings each)."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch.ops.kernels import build
    from nonuniformffts_tpu_torch.ops.kernels.common import (INTERP1D_GATHER_BYTES,
                                                             VALUE_TYPES, interp1d_gathers)

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    lib = build.load()
    for name in dtypes:
        plan0 = nufft.PlanNUFFT(np.dtype(name), SHAPES[1], m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        _, sb, ncomp = VALUE_TYPES[plan0.dtype]
        tol = 1e-6 if sb == 4 else 1e-14
        for np_ in nps or INTERP1D_SWEEP_NP:
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((1, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            plan = nufft.set_points(plan0, pts)
            perm = plan.sort_perm
            inverse_ms = {how: cuda_time_ms(lambda how=how: _inverse(perm, how), reps=reps)[0]
                          for how in ("index_put", "scatter", "index_put", "scatter")}
            inv = _inverse(perm)
            if not torch.equal(inv, _inverse(perm, "scatter")):
                raise AssertionError("the two inverse permutations differ")
            for C in (1, 2):
                grid = torch.randn((C,) + plan.shape_over, generator=gen, device=dev,
                                   dtype=plan0.dtype)
                runs = {way: (lambda way=way: _raw_interp(
                    lib, plan, grid, gather=way == "gather", inv=inv))
                    for way in ("scatter", "gather")}
                times = {k: [] for k in runs}
                outs = {}
                for _ in range(2):
                    for k in ("scatter", "gather", "gather", "scatter"):
                        ms_, outs[k] = cuda_time_ms(runs[k], reps=reps)
                        times[k].append(ms_)
                err = rel_l2(outs["gather"], outs["scatter"])
                if not err <= tol:
                    raise AssertionError(f"interp1d sweep {name} C={C} {np_}: the paths "
                                         f"differ, rel L2 {err:.3e}")
                med = {k: statistics.median(t) for k, t in times.items()}
                nbytes = C * np_ * sb * ncomp
                print(json.dumps({
                    "probe": "interp1d_sweep", "card": card, "dtype": name, "C": C, "np": np_,
                    "out_bytes": nbytes, "ms": med, "all_ms": times,
                    "scatter_over_gather": med["scatter"] / med["gather"],
                    "inverse_ms": inverse_ms,
                    "equal": bool(torch.equal(outs["gather"], outs["scatter"])),
                    "wrapper_gathers": interp1d_gathers(np_, C, sb * ncomp),
                    "threshold_bytes": INTERP1D_GATHER_BYTES}), flush=True)
                del grid, outs, runs
            del plan, pts, perm, inv
            torch.cuda.empty_cache()


#: The kernels that ``--<kind>-parts`` takes apart: the shipped source's
#: stem, the kernel's name in a ptxas log (a regular expression), the
#: dimension and the copies (a ``*_PARTS`` table).
PARTS = {
    "spread3d": ("spread_3d", "spread_3d_(?:shared_)?kernel", 3, SPREAD3D_PARTS),
    "interp3d": ("interp_3d", "interp_3d_kernel", 3, INTERP3D_PARTS),
    "spread2d": ("spread_2d", "spread_2d_kernel", 2, SPREAD2D_PARTS),
    "interp2d": ("interp_2d", "interp_2d_(?:point_)?kernel", 2,
                 {**INTERP2D_PARTS, **POINT_INTERP2D_PARTS}),
    "spread1d": ("spread_1d", "spread_1d_kernel", 1, SPREAD1D_PARTS),
    "interp1d": ("interp_1d", "interp_1d_(?:point_)?kernel", 1, INTERP1D_PARTS),
}


def probe_parts(kind: str, seed: int, dtypes, nps, ms, reps: int = 5,
                designs: bool = False, nchans=(1,)) -> None:
    """``--<kind>-parts`` (``kind`` a key of ``PARTS``), and with
    ``designs`` ``--interp2d``: the shipped source and its copies (the
    parts; or ``INTERP2D_DESIGNS`` and the staged design,
    ``_STAGED_INTERP_2D_SRC``), built for the M of ``ms`` alone into
    ``build/chip_probe/``, as raw launches in turns (in order, then
    reversed) on the same sorted points and values or grid, CUDA events,
    median of ``reps`` after one warm-up; the shipped build and every other
    design held against the plain version (a parts copy computes wrong
    values by design); the wrapper call (the grid's zeroing or the output's
    allocation and the launch path) and its host time.  sigma = 1.5, BKB
    FastApproximation, uniform points, the chooser's block dims; each dtype
    at its main-path Np and 16,777,216 (1D: 1M and 10M), and with
    ``designs`` also at 377,487 (rho = 0.01).  A spread runs each C of
    ``nchans`` transforms a launch (in 3D more than one runs the
    shared-staging kernel), held against the plain version of its first
    and last transform.  One JSON line a dtype, M, Np and C, with the bound
    (``chip_smoke.kernel_bound``) and the points a block."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, kernel_bound, nvidia_smi_line, rel_l2
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.ops.kernels.common import VALUE_TYPES

    stem, kernel, D, parts = PARTS[kind]
    spread = kind.startswith("spread")
    label = kind if designs else f"{kind}_parts"
    texts = _edited_sources(stem, INTERP2D_DESIGNS if designs else parts, ms)
    if designs:
        texts["staged"] = _m_only(_STAGED_INTERP_2D_SRC, ms)
    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = _build_all(f"{label}_", texts)
    for k in libs:
        print(f"ptxas {k}: {_registers(_probe_log(f'{label}_{k}'), kernel)}", flush=True)
    keys = list(libs)
    for name in dtypes:
        for m in ms:
            plan0 = nufft.PlanNUFFT(np.dtype(name), SHAPES[D], m=m, sigma=1.5,
                                    spread_method="blocked", device=dev)
            tol = 1e-5 if plan0.real_dtype == torch.float32 else 1e-12
            default = ((1_000_000, 10_000_000) if D == 1 else (MAIN_NP[name], 16_777_216))
            for np_ in nps or default + ((377_487,) if designs else ()):
                gen = torch.Generator(device=dev).manual_seed(seed + np_)
                pts = torch.rand((D, np_), generator=gen, device=dev,
                                 dtype=plan0.real_dtype) * (2 * math.pi)
                plan = nufft.set_points(plan0, pts)
                chunked = dataclasses.replace(plan, chunk_size=1 << 16)
                for C in nchans if spread else (1,):
                    if spread:
                        vp = torch.randn((C, np_), generator=gen, device=dev, dtype=plan0.dtype)
                        vals = vp if D == 1 else vp[:, plan.sort_perm].contiguous()
                        ends = _plain_ends(plan, vp)
                        runs = {k: (lambda lib=lib: _raw_spread(lib, plan, vals))
                                for k, lib in libs.items()}
                        wrapper = lambda: blocked.spread_blocked(plan, vp)  # noqa: E731
                        error = lambda got: _ends_err(got, ends)  # noqa: E731
                    else:
                        grid = torch.randn((1,) + plan.shape_over, generator=gen, device=dev,
                                           dtype=plan0.dtype)
                        want = blocked.interpolate_blocked_plain(chunked, grid)
                        runs = {k: (lambda lib=lib, k=k: _raw_interp(
                            lib, plan, grid, "staged" if k == "staged" else "nufft"))
                            for k, lib in libs.items()}
                        wrapper = lambda: blocked.interpolate_blocked(plan, grid)  # noqa: E731
                        error = lambda got: rel_l2(got, want)  # noqa: E731
                    times, errs = {k: [] for k in runs}, {}
                    for order in (keys, keys[::-1]):
                        for k in order:
                            ms_, got = cuda_time_ms(runs[k], reps=reps)
                            times[k].append(ms_)
                            err = error(got)
                            errs[k] = max(errs.get(k, 0.0), err)
                            if (designs or k == "shipped") and not err <= tol:
                                raise AssertionError(f"{label} {name} m={m} {np_} C={C} {k}: "
                                                     f"rel L2 {err:.3e} vs plain")
                            del got
                    call_ms, got = cuda_time_ms(wrapper)
                    err = error(got)
                    if not err <= tol:
                        raise AssertionError(f"{label} {name} m={m} {np_} C={C} wrapper: rel L2 "
                                             f"{err:.3e}")
                    del got
                    bound_ms, bound_by = kernel_bound("spread" if spread else "interp", plan, C)
                    line = {"probe": label, "card": card, "dtype": name, "m": m, "np": np_,
                            "nchan": C, "block_dims": list(plan.block_dims),
                            "points_a_block": _points_a_block(plan),
                            "ms": {k: statistics.median(t) for k, t in times.items()},
                            "call_ms": call_ms,
                            "call_host_us": _host_us(wrapper, 100 if C == 1 else 5),
                            "rel_l2": errs, "bound_ms": bound_ms, "bound_by": bound_by}
                    if designs:
                        for k in keys[1:]:
                            line[f"{k}_over_shipped"] = line["ms"][k] / line["ms"]["shipped"]
                    print(json.dumps(line), flush=True)
                    del runs, wrapper, error
                    torch.cuda.empty_cache()
                del plan, chunked, pts
                torch.cuda.empty_cache()


#: Copies of csrc/window_weights.cu with one phase taken out, for
#: ``--weights``: the taps' evaluation (each tap a number from the fraction)
#: and their stores (the taps summed into a register that is written under
#: a condition that never holds).  Their taps are wrong; only their times
#: are read.
WEIGHTS_PARTS = {
    "no_eval": {
        "      for (int v = 0; v < V; ++v) w.c[v] = direct_tap<KIND, M, T>(win, d, t, X.c[v]);":
        "      for (int v = 0; v < V; ++v) w.c[v] = X.c[v] + T(t);",
        "    for (int v = 0; v < V; ++v) nufft::bspline_taps<S>(X.c[v], b[v]);":
        "    for (int v = 0; v < V; ++v)\n      for (int t = 0; t < S; ++t) b[v][t] = X.c[v] + T(t);"},
    "no_store": {
        "      o[t * groups] = w;\n    }\n  }\n}\n":
        "      for (int v = 0; v < V; ++v) sink += w.c[v];\n    }\n  }\n"
        "  if (sink == T(1.25e-30)) o[0].c[0] = sink;\n}\n",
        "  Vec<T, V>* o = reinterpret_cast<Vec<T, V>*>(out + d * S * np + j);":
        "  Vec<T, V>* o = reinterpret_cast<Vec<T, V>*>(out + d * S * np + j);\n  T sink = T(0);",
        "      o[t * groups] = w;": "      for (int v = 0; v < V; ++v) sink += w.c[v];"},
}
#: The windows of ``--weights``: every kind K3 evaluates (WINDOW_MODES keys
#: of chip_smoke.py).
WEIGHTS_WINDOWS = ("KB Direct", "BKB Direct", "Gaussian Direct", "B-spline Direct")
#: Point counts at N = 256^3 (sigma = 2, grid 512^3): the main path's two.
WEIGHTS_NP = (1_000_000, 16_777_216)
#: Points on which each raw launch is held against the plain version.
WEIGHTS_CHECKED = 1 << 20


def _raw_weights(lib, name: str, plan, params, out):
    """One launch of the window-weights entry point ``name`` of ``lib`` on
    the plan's sorted fractions into ``out`` (D, 2M, Np)."""
    import torch

    from nonuniformffts_tpu_torch.ops.kernels import build

    fn = getattr(lib, name)
    fn.argtypes = build._SIGNATURES["nufft_window_weights_" + name.rsplit("_", 1)[1]]
    err = fn(plan.fracs_sorted.data_ptr(), params, out.data_ptr(), plan.num_points,
             plan.ndim, plan.m, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def probe_weights(seed: int, nps, ms) -> None:
    """K3 alone: raw launches of the shipped window-weights kernel and of
    the parts copies (``WEIGHTS_PARTS``), in turns on the same sorted points
    into one preallocated table (two passes, CUDA events, median of 5 after
    one warm-up), beside the wrapper call
    (``blocked.window_weights_blocked``: the table's allocation and the
    launch) and its host time, for every K3 window, float taps (complex64
    plans) and double taps (complex128), N = 256^3, sigma = 2, the M of
    ``ms``, uniform points.  The shipped build is held against the plain
    version on the first ``WEIGHTS_CHECKED`` points.  The bound by bytes
    reads each fraction once and writes each tap once; the bound by
    operations counts ``chip_smoke.tap_ops`` a tap (its I0 / exp / sqrt
    estimates) over the FP32 or FP64 peak.  One JSON line a window, dtype,
    M and Np."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import (HBM_BYTES_PER_S, PEAK_FLOPS, WINDOW_MODES, cuda_time_ms,
                            nvidia_smi_line, rel_l2, tap_ops)
    from nonuniformffts_tpu_torch.ops.kernels import blocked, build

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = _build_all("weights_", _edited_sources("window_weights", WEIGHTS_PARTS, ms))
    for k in libs:
        print(f"ptxas {k}: {_registers(_probe_log('weights_' + k), 'window_weights_kernel')}",
              flush=True)
    keys = list(libs)
    for dtype in (np.complex64, np.complex128):
        for m in ms:
            for mode in WEIGHTS_WINDOWS:
                kernel, evalmode = WINDOW_MODES[mode]
                plan0 = nufft.PlanNUFFT(dtype, (256,) * 3, m=m, sigma=2.0,
                                        kernel=getattr(nufft, kernel)(),
                                        kernel_evalmode=getattr(nufft, evalmode)(),
                                        spread_method="blocked", device=dev)
                suffix = "f32" if plan0.real_dtype == torch.float32 else "f64"
                sb = 4 if suffix == "f32" else 8
                tol = 1e-5 if sb == 4 else 1e-12
                params = build.WindowParams.from_pack(plan0.window)
                for np_ in nps or WEIGHTS_NP:
                    gen = torch.Generator(device=dev).manual_seed(seed + np_)
                    pts = torch.rand((3, np_), generator=gen, device=dev,
                                     dtype=plan0.real_dtype) * (2 * math.pi)
                    plan = nufft.set_points(plan0, pts)
                    head = dataclasses.replace(
                        plan, fracs_sorted=plan.fracs_sorted[:, :WEIGHTS_CHECKED].contiguous())
                    want = blocked.window_weights_blocked_plain(head)
                    out = torch.empty((3, 2 * m, np_), dtype=plan0.real_dtype, device=dev)
                    times, errs = {k: [] for k in libs}, {}
                    for order in (keys, keys[::-1]):
                        for k in order:
                            ms_, _ = cuda_time_ms(lambda k=k: _raw_weights(
                                libs[k], f"nufft_window_weights_{suffix}", plan, params, out))
                            times[k].append(ms_)
                            if k == "shipped":
                                err = rel_l2(out[:, :, :WEIGHTS_CHECKED], want)
                                errs[k] = max(errs.get(k, 0.0), err)
                                if not err <= tol:
                                    raise AssertionError(f"weights {mode} {suffix} m={m} {np_} "
                                                         f"shipped: rel L2 {err:.3e} vs plain")
                    wrapper = lambda: blocked.window_weights_blocked(plan)  # noqa: E731
                    call_ms, got = cuda_time_ms(wrapper)
                    err = rel_l2(got[:, :, :WEIGHTS_CHECKED], want)
                    if not err <= tol:
                        raise AssertionError(f"weights {mode} wrapper: rel L2 {err:.3e}")
                    del got
                    S = 2 * m
                    bound_bytes = 1e3 * (np_ * 3 * sb * (1 + S)) / HBM_BYTES_PER_S
                    bound_ops = 1e3 * np_ * 3 * S * tap_ops(plan) / PEAK_FLOPS[sb]
                    print(json.dumps({
                        "probe": "weights", "card": card, "window": mode, "taps": suffix,
                        "m": m, "np": np_, "ms": {k: statistics.median(t)
                                                   for k, t in times.items()},
                        "call_ms": call_ms, "call_host_us": _host_us(wrapper, 100),
                        "rel_l2": errs, "bound_bytes_ms": bound_bytes,
                        "bound_ops_ms": bound_ops, "tap_ops": tap_ops(plan)}), flush=True)
                    del plan, head, want, out, pts
                    torch.cuda.empty_cache()


#: The rows of ``--exec-1d``: chip_smoke.py phase 9's, the 1D main path
#: (shape, dtype, point counts).
EXEC_1D_ROWS = tuple(((1 << 20,), d, (1_000_000, 10_000_000))
                     for d in ("complex64", "complex128", "float32", "float64"))


def probe_exec_1d(seed: int, reps: int = 5) -> None:
    """set_points, exec_type1 and exec_type2 (CUDA events, median of
    ``reps`` after one warm-up, through the public API alone) on the 1D
    main path (``EXEC_1D_ROWS``), m = 4, sigma = 1.5, BKB
    FastApproximation, uniform points.  The package is the one ``--root``
    puts first on the path, so that one call can time two trees in turns.
    One JSON line a row, with set_points plus each transform."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line

    card = nvidia_smi_line()
    dev = torch.device("cuda")
    print(f"{card}; package {Path(nufft.__file__).resolve().parent}", flush=True)
    for shape, dtype, nps in EXEC_1D_ROWS:
        plan0 = nufft.PlanNUFFT(np.dtype(dtype), shape, m=4, sigma=1.5,
                                spread_method="blocked", device=dev)
        u = torch.randn((1,) + plan0.spectral_shape, dtype=plan0.complex_dtype,
                        device=dev)[0]
        for np_ in nps:
            gen = torch.Generator(device=dev).manual_seed(seed + np_)
            pts = torch.rand((1, np_), generator=gen, device=dev,
                             dtype=plan0.real_dtype) * (2 * math.pi)
            vp = torch.randn((np_,), generator=gen, device=dev, dtype=plan0.dtype)
            t_set, plan = cuda_time_ms(lambda: nufft.set_points(plan0, pts), reps=reps)
            t_t1, _ = cuda_time_ms(lambda: nufft.exec_type1(plan, vp), reps=reps)
            t_t2, _ = cuda_time_ms(lambda: nufft.exec_type2(plan, u), reps=reps)
            print(json.dumps({"probe": "exec_1d", "card": card, "dim": "1D",
                              "dtype": dtype, "window": "BKB Fast", "np": np_,
                              "set_points_ms": t_set, "exec_type1_ms": t_t1,
                              "exec_type2_ms": t_t2, "set_plus_type1_ms": t_set + t_t1,
                              "set_plus_type2_ms": t_set + t_t2}), flush=True)
            del plan, pts, vp
            torch.cuda.empty_cache()


DIRECT_NP = (1, 3, 10, 30, 100, 300, 1_000, 3_000, 10_000, 30_000, 100_000)
#: A row's direct path is not run past this multiple of the blocked time.
DIRECT_STOP = 10.0


def probe_direct(seed: int, dtypes, nps, reps: int = 3) -> None:
    """The direct NUDFT (``ops/direct.py``) against the blocked main path
    (m = 4, sigma = 1.5, BKB FastApproximation), both through the public
    API: set_points, exec_type1 and exec_type2 (CUDA events, median of
    ``reps`` after one warm-up), at 256^3, 4096^2 and 2^20 for each of
    ``dtypes`` and Np in ``nps``, uniform points, with the direct path's
    err1 / err2 against exact float64 sums (``chip_smoke._err1`` /
    ``_err2``).  For complex64 also the direct path with complex64 factors
    and product (``direct.FACTOR_DTYPE`` patched, TF32 off): its time and
    errors.  A row stops running the direct path once its exec_type1 +
    exec_type2 exceeds ``DIRECT_STOP`` times the blocked path's.  Per row,
    the crossover Np (log-linear between the last Np where direct wins and
    the first where it loses) and the ``c`` of ``direct.prefers_direct``
    that puts the model's crossover there."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import _err1, _err2, _rank1_spectrum, cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops import direct

    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    dev = torch.device("cuda")
    print(card, flush=True)
    summary = []
    for D in (3, 2, 1):
        shape = SHAPES[D]
        for name in dtypes:
            dtype = np.dtype(name)
            bplan0 = nufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, spread_method="blocked",
                                     device=dev)
            dplan0 = nufft.PlanNUFFT(dtype, shape, spread_method="direct", device=dev)
            a, u_np = _rank1_spectrum(shape, False, seed)
            u = torch.as_tensor(u_np, device=dev).to(bplan0.complex_dtype)
            del u_np
            rows, running = [], True
            for np_ in nps:
                gen = torch.Generator(device=dev).manual_seed(seed + np_)
                pts = torch.rand((D, np_), generator=gen, device=dev,
                                 dtype=bplan0.real_dtype) * (2 * math.pi)
                vp = torch.randn((np_,), generator=gen, device=dev, dtype=bplan0.dtype)
                row = {"probe": "direct", "card": card, "dim": D, "dtype": name, "np": np_}
                for label, plan0 in (("blocked", bplan0), ("direct", dplan0)):
                    if label == "direct" and not running:
                        break
                    t_set, plan = cuda_time_ms(lambda: nufft.set_points(plan0, pts), reps=reps)
                    t1, u1 = cuda_time_ms(lambda: nufft.exec_type1(plan, vp), reps=reps)
                    t2, v2 = cuda_time_ms(lambda: nufft.exec_type2(plan, u), reps=reps)
                    row[label] = dict(set_points_ms=t_set, exec_type1_ms=t1, exec_type2_ms=t2,
                                      err1=_err1(pts, vp, u1, shape, False, seed),
                                      err2=_err2(pts, v2, a, False, seed))
                    if label == "direct" and name == "complex64":
                        old = direct.FACTOR_DTYPE
                        direct.FACTOR_DTYPE = torch.complex64
                        try:
                            t1, u1 = cuda_time_ms(lambda: nufft.exec_type1(plan, vp), reps=reps)
                            t2, v2 = cuda_time_ms(lambda: nufft.exec_type2(plan, u), reps=reps)
                        finally:
                            direct.FACTOR_DTYPE = old
                        row["direct_complex64_factors"] = dict(
                            exec_type1_ms=t1, exec_type2_ms=t2,
                            err1=_err1(pts, vp, u1, shape, False, seed),
                            err2=_err2(pts, v2, a, False, seed))
                    del plan, u1, v2
                    torch.cuda.empty_cache()
                if "direct" in row:
                    b, d = row["blocked"], row["direct"]
                    row["direct_over_blocked"] = ((d["exec_type1_ms"] + d["exec_type2_ms"])
                                                  / (b["exec_type1_ms"] + b["exec_type2_ms"]))
                    running = row["direct_over_blocked"] <= DIRECT_STOP
                    rows.append(row)
                print(json.dumps(row), flush=True)
                del pts, vp
                torch.cuda.empty_cache()
            first_loss = next((i for i, r in enumerate(rows)
                               if r["direct_over_blocked"] >= 1.0), None)
            if first_loss is None:
                crossover = None
            elif first_loss == 0:
                crossover = 0.0
            else:
                (n0, r0), (n1, r1) = ((r["np"], r["direct_over_blocked"])
                                      for r in rows[first_loss - 1:first_loss + 1])
                f = math.log(r0) / (math.log(r0) - math.log(r1))
                crossover = math.exp(math.log(n0) + f * (math.log(n1) - math.log(n0)))
            over = bplan0.shape_over
            c = (None if crossover is None else
                 direct.direct_macs(crossover, bplan0.spectral_shape)
                 / direct.blocked_dft_macs(over))
            summary.append({"probe": "direct_crossover", "card": card, "dim": D, "dtype": name,
                            "crossover_np": crossover, "c": c})
            print(json.dumps(summary[-1]), flush=True)
    print(json.dumps({"probe": "direct_summary", "rows": summary}), flush=True)


#: Point counts of ``--set-points`` a dimension: the main paths'.
SET_POINTS_NP = {3: (16_777_216,), 2: (16_777_216,), 1: (10_000_000,)}
#: ``--set-points``' point layouts: uniform over [-1, 2pi + 1) (some fold);
#: every block empty but the inner ones (``empty_ends``); every point in the
#: first block, or in the last (one thread of the sorted-state kernel then
#: writes every other block's start).
SET_POINTS_CASES = ("uniform", "empty_ends", "first_block", "last_block")


def _set_points_layout(case: str, gen, plan, np_: int):
    """(D, Np) card points of one ``SET_POINTS_CASES`` layout."""
    import torch

    D = plan.ndim
    u = torch.rand((D, np_), generator=gen, device="cuda", dtype=torch.float64)
    if case == "uniform":
        return (u * (2 * math.pi + 2) - 1).to(plan.real_dtype)
    rows = []
    for d, (n, b) in enumerate(zip(plan.shape_over, plan.block_dims)):
        first, last = {"empty_ends": (b, n - b), "first_block": (0, b),
                       "last_block": (n - b, n)}[case]
        lo, hi = first * 2 * math.pi / n, last * 2 * math.pi / n
        # inside [lo, hi) after rounding to the points' type
        rows.append(lo + (hi - lo) * (0.0001 + 0.9998 * u[d]))
    return torch.stack(rows).to(plan.real_dtype)


def probe_set_points(seed: int, dims, dtypes, nps, reps: int, cases=SET_POINTS_CASES) -> None:
    """``set_points``' split and sort (``plan._sorted_state_kernels``: the
    bin-key kernel, the stable sort, the sorted-state kernel) against their
    plain version on the card (``plan._sorted_state_plain``), at
    ``SHAPES`` and ``SET_POINTS_NP`` (m = 4, sigma = 1.5) for each point
    layout of ``cases`` (``SET_POINTS_CASES``), CUDA events, median of
    ``reps`` after one warm-up, in turns plain, kernels, kernels, plain;
    also the whole ``set_points`` and each of the three alone (the wrappers
    ``blocked.bin_keys`` and ``sorted_state``, ``torch.sort``), and
    ``blocking.block_starts`` (the plain chain's block starts, one binary
    search a block) on the same sorted keys.  The kernels' cells,
    fractions, order and block starts are held equal to the plain chain's.
    Bounds by the function's bytes, each input read once and each output
    written once: the keys D coordinates in, a key out a point; the sorted
    state a key, an index and D coordinates in, D cells and D fractions out
    a point, and the block starts.  The records that the key kernel packs
    for the gather (2 or 4 coordinates in 2D / 3D: written once, read once
    in place of the D coordinates) are left out of the bounds and reported
    beside them (``record_ms``).  One JSON line a row."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import HBM_BYTES_PER_S, cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch import blocking
    from nonuniformffts_tpu_torch import plan as plan_mod
    from nonuniformffts_tpu_torch.ops.kernels import blocked

    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    for D in dims:
        for name in dtypes:
            plan = nufft.PlanNUFFT(np.dtype(name), SHAPES[D], m=4, sigma=1.5,
                                   spread_method="blocked", device=dev)
            geo = (plan.shape_over, plan.block_dims)
            for np_ in nps or SET_POINTS_NP[D]:
                for case in cases:
                    gen = torch.Generator(device=dev).manual_seed(seed + np_)
                    pts = _set_points_layout(case, gen, plan, np_)
                    calls = {
                        "plain": lambda: plan_mod._sorted_state_plain(plan, pts),
                        "kernels": lambda: plan_mod._sorted_state_kernels(plan, pts),
                    }
                    times = {k: [] for k in calls}
                    for k in ("plain", "kernels", "kernels", "plain"):
                        ms_, out = cuda_time_ms(calls[k], reps=reps)
                        times[k].append(ms_)
                        if k == "kernels":
                            got = out
                        else:
                            want = out
                    if not all(torch.equal(g, w) for g, w in zip(got[:4], want[:4])):
                        raise AssertionError(f"set_points kernels {D}D {name} {np_} {case}: "
                                             "not equal to the plain chain")
                    del got, want, out
                    whole_ms, _ = cuda_time_ms(lambda: nufft.set_points(plan, pts), reps=reps)
                    keys_ms, (keys, records) = cuda_time_ms(
                        lambda: blocked.bin_keys(pts, *geo), reps=reps)
                    sort_ms, (skeys, perm) = cuda_time_ms(
                        lambda: torch.sort(keys, stable=True), reps=reps)
                    state_ms, _ = cuda_time_ms(
                        lambda: blocked.sorted_state(records, skeys, perm, *geo), reps=reps)
                    starts_ms, _ = cuda_time_ms(
                        lambda: blocking.block_starts(skeys, *geo), reps=reps)
                    sb = pts.element_size()
                    rec = blocked.BIN_RECORD[D] * sb if D > 1 else 0
                    nblocks, _ = blocking.bin_counts(*geo)
                    keys_bytes = np_ * (D * sb + 4)
                    state_bytes = np_ * (4 + 8 + D * sb + D * 4 + D * sb) + 4 * (nblocks + 1)
                    record_bytes = np_ * (2 * rec - D * sb) if rec else 0
                    print(json.dumps({
                        "probe": "set_points", "card": card, "dim": D, "dtype": name,
                        "np": np_, "case": case, "block_dims": list(plan.block_dims),
                        "nblocks": nblocks,
                        "plain_ms": times["plain"], "kernels_ms": times["kernels"],
                        "set_points_ms": whole_ms, "keys_ms": keys_ms, "sort_ms": sort_ms,
                        "state_ms": state_ms, "block_starts_ms": starts_ms,
                        "keys_bound_ms": 1e3 * keys_bytes / HBM_BYTES_PER_S,
                        "state_bound_ms": 1e3 * state_bytes / HBM_BYTES_PER_S,
                        "record_ms": 1e3 * record_bytes / HBM_BYTES_PER_S,
                        "equal": True}), flush=True)
                    del pts, keys, records, skeys, perm
                    torch.cuda.empty_cache()


#: ``--deconvolve``'s rows: value type and transforms a call (the 32-coil
#: cell's call, then one transform of each main path).
DECONVOLVE_ROWS = (("complex64", 32), ("complex64", 1), ("float32", 1), ("complex128", 1),
                   ("float64", 1))


def probe_deconvolve(seed: int, reps: int) -> None:
    """The deconvolution's three stages (``execution.py``: type 1's
    ``t1_deconv_stage``, type 2's ``t2_pad_stage`` and the unscaled
    ``t2_pad_modes_stage`` of a grouped call) at N = 256^3 over the 384^3
    grid (m = 4, sigma = 1.5) for ``DECONVOLVE_ROWS``, CUDA events, median
    of ``reps`` after one warm-up, beside their bound by bytes (each kept
    mode read once, each output written once); with one transform also the
    plain torch chain (``deconvolve_truncate_plain``,
    ``deconvolve_pad_plain``), in turns kernel, plain, plain, kernel.  One
    JSON line a stage."""
    import torch

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import HBM_BYTES_PER_S, cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch import execution as ex
    from nonuniformffts_tpu_torch.ops import deconvolve

    card = nvidia_smi_line()
    print(card, flush=True)
    for name, C in DECONVOLVE_ROWS:
        plan = nufft.PlanNUFFT(np.dtype(name), SHAPES[3], m=4, sigma=1.5, ntransforms=C,
                               device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed + C)
        spec = torch.randn((C,) + plan.spectral_shape_over, generator=gen, device="cuda",
                           dtype=plan.complex_dtype)
        uhat = torch.randn((C,) + plan.spectral_shape, generator=gen, device="cuda",
                           dtype=plan.complex_dtype)
        modes, over = math.prod(plan.spectral_shape), math.prod(plan.spectral_shape_over)
        nbytes = {"truncate": 2 * modes, "pad": modes + over, "pad_unscaled": modes + over}
        stages = {
            "truncate": (lambda: ex.t1_deconv_stage(plan, spec),
                         lambda: deconvolve.deconvolve_truncate_plain(
                             spec, plan.index_ranges, plan.phihat_inv, plan.normfactor)),
            "pad": (lambda: ex.t2_pad_stage(plan, uhat),
                    lambda: deconvolve.deconvolve_pad_plain(
                        uhat, plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv)),
            "pad_unscaled": (lambda: ex.t2_pad_modes_stage(plan, uhat), None),
        }
        for stage, (kernel, plain) in stages.items():
            times = {"kernel": [], "plain": []}
            order = ("kernel", "plain", "plain", "kernel") if plain and C == 1 else ("kernel",)
            for side in order:
                ms, _ = cuda_time_ms(kernel if side == "kernel" else plain, reps=reps)
                times[side].append(ms)
            bound_ms = 1e3 * C * nbytes[stage] * spec.element_size() / HBM_BYTES_PER_S
            kernel_ms = statistics.mean(times["kernel"])
            print(json.dumps({
                "probe": "deconvolve", "card": card, "dtype": name, "transforms": C,
                "stage": stage, "kernel_ms": times["kernel"], "plain_ms": times["plain"] or None,
                "bound_ms": bound_ms, "bound_share": bound_ms / kernel_ms}), flush=True)
        del spec, uhat, plan
        torch.cuda.empty_cache()


#: The caching allocator's counters ``--alloc-window`` reads around each
#: stretch of steps.
ALLOC_COUNTERS = ("segment.all.allocated", "segment.all.freed", "num_alloc_retries",
                  "num_device_alloc", "num_device_free")


def _our_frames(frames, count: int = 4) -> list:
    """The innermost ``count`` Python frames of the repo's packages."""
    return [f"{Path(f['filename']).name}:{f['line']}:{f['name']}" for f in frames
            if "nonuniformffts_tpu_torch" in f["filename"] or "nufftbench" in f["filename"]][:count]


def probe_alloc_window(root: Path, cells, seed: int, seconds: float) -> None:
    """Which device allocations the benchmark's own runs make inside their
    measured stretches (``nufftbench/harness.py``), for the package the
    harness imports (this tree's, or ``--root``'s).  Each cell runs once
    traced and once untraced through ``harness.run_cell``; around each
    stretch of steps (``Window.run``: the untraced window, the traced run's
    profiled stretch and its timed part) the caching allocator's counters
    (``ALLOC_COUNTERS``) are read, and its history records each segment it
    maps or frees there with the size and the repo's innermost frames.  The
    profiled stretch's trace is also searched for ``cudaMalloc`` and
    ``cudaFree`` calls inside the window (any library's, the caching
    allocator's included), each with its duration and the ``nufft:`` span
    and host operation around it.  One JSON line a run."""
    import torch

    from chip_smoke import nvidia_smi_line
    from nufftbench import harness

    card = nvidia_smi_line()
    print(card, flush=True)
    found = []
    run, summarise = harness.Window.run, harness.tracing.summarise_file

    def counters():
        stats = torch.cuda.memory_stats()
        return {k: stats.get(k, 0) for k in ALLOC_COUNTERS}

    def window_run(win, step, k0, secs, timed=True):
        torch.cuda.synchronize()
        before = counters()
        torch.cuda.memory._record_memory_history(stacks="python", max_entries=200_000)
        try:
            return run(win, step, k0, secs, timed)
        finally:
            torch.cuda.synchronize()
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            after = counters()
            events = [e for trace in snap["device_traces"] for e in trace
                      if e["action"] not in ("alloc", "free_requested", "free_completed")]
            found.append({
                "stretch": "timed" if timed else "profiled", "first_step": k0,
                "counters": {k: after[k] - before[k] for k in after},
                "reserved_gib": torch.cuda.memory_reserved() / 2**30,
                "segments": [{"action": e["action"], "bytes": e["size"],
                              "at": _our_frames(e.get("frames", []))} for e in events[:20]]})

    def summarise_file(path):
        with open(path) as f:
            spans = [e for e in json.load(f).get("traceEvents", [])
                     if e.get("ph") == "X" and "dur" in e]
        win = [e for e in spans if e.get("name") == harness.tracing.WINDOW]
        if win:
            lo, hi = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
            host = [e for e in spans if e.get("cat") in ("user_annotation", "cpu_op")]
            calls = []
            for e in spans:
                if e.get("cat") != "cuda_runtime" or e.get("name") not in (
                        "cudaMalloc", "cudaFree") or not lo <= float(e["ts"]) <= hi:
                    continue
                a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                around = sorted((h for h in host if float(h["ts"]) <= a
                                 and float(h["ts"]) + float(h["dur"]) >= b),
                                key=lambda h: float(h["ts"]))
                labels = [h["name"] for h in around if h["name"].startswith("nufft:")]
                ops = [h["name"] for h in around if h.get("cat") == "cpu_op"]
                calls.append({"call": e["name"], "ms": (b - a) * 1e-3,
                              "at_ms": (a - lo) * 1e-3, "span": labels[-1] if labels else None,
                              "op": ops[-1] if ops else None})
            found.append({"stretch": "profiled trace", "runtime_calls": calls})
        return summarise(path)

    harness.Window.run, harness.tracing.summarise_file = window_run, summarise_file
    try:
        for name in cells:
            cell = harness.load_cell(root, name)
            for trace in (True, False):
                found.clear()
                result = harness.run_cell(cell, seed, seconds, trace, "cuda")
                metrics = {k: v["value"] for k, v in result["metrics"].items()
                           if k in ("device_idle_pct", "step_ms")}
                print(json.dumps({
                    "probe": "alloc_window", "card": card, "cell": name, "trace": trace,
                    "correct": result["correct"], "metrics": metrics,
                    "idle_gaps": result.get("breakdown", {}).get("idle_gaps", [])[:4],
                    "peak_bytes": result["device"]["memory_peak_bytes"],
                    "stretches": found}), flush=True)
                torch.cuda.empty_cache()
    finally:
        harness.Window.run, harness.tracing.summarise_file = run, summarise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dim", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--np", type=int, nargs="+", default=None)
    parser.add_argument("--dtype", nargs="+",
                        default=["complex64", "complex128", "float32", "float64"])
    parser.add_argument("--gloo", action="store_true",
                        help="probe which gloo calls take CUDA tensors, and stop")
    parser.add_argument("--spread3d", action="store_true",
                        help="time the 3D spread kernel over block geometries, and stop")
    parser.add_argument("--spread2d", action="store_true",
                        help="time the 2D spread kernel over block geometries and fit its "
                             "cost model, and stop")
    for kind in PARTS:
        parser.add_argument(f"--{kind}-parts", action="store_true",
                            help=f"time the {kind} kernel with each phase taken out, and stop")
    parser.add_argument("--interp2d", action="store_true",
                        help="time the 2D interpolation kernel against its first design "
                             "and the staged design tried in its place, and stop")
    parser.add_argument("--weights", action="store_true",
                        help="time the window-weights kernel K3 (raw launches, its parts "
                             "and the wrapper call) for four windows in 3D, and stop")
    parser.add_argument("--exec-1d", action="store_true",
                        help="time set_points and both transforms on the 1D main path "
                             "(chip_smoke.py phase 9), and stop")
    parser.add_argument("--direct", action="store_true",
                        help="time the direct NUDFT against the blocked path from 1 to "
                             "100,000 points in 3D, 2D and 1D, and stop")
    parser.add_argument("--interp1d-sweep", action="store_true",
                        help="time the 1D interpolation's point and staged paths against "
                             "each other from 1M to 10M points, and stop")
    parser.add_argument("--set-points", action="store_true",
                        help="time set_points' key and sorted-state kernels and the sort "
                             "against the plain chain on the main paths' shapes, and stop")
    parser.add_argument("--deconvolve", action="store_true",
                        help="time the deconvolution's stages (the kernels of "
                             "csrc/deconvolve.cu) against the plain chain and their "
                             "bounds at 256^3 over 384^3, and stop")
    parser.add_argument("--alloc-window", nargs="+", default=None, metavar="CELL",
                        help="run each benchmark cell traced and untraced, count the "
                             "device allocations inside its measured stretches, and stop")
    parser.add_argument("--seconds", type=float, default=10.0,
                        help="the measured window of --alloc-window's runs")
    parser.add_argument("--root", default=None,
                        help="import nonuniformffts_tpu_torch from this tree (default: "
                             "the script's own)")
    parser.add_argument("--reps", type=int, default=5,
                        help="timed launches a median of the -parts probes, --interp2d, "
                             "--interp1d-sweep, --exec-1d and --set-points")
    parser.add_argument("--m", type=int, nargs="+", default=[4],
                        help="the M of the -parts probes, --interp2d and --weights")
    parser.add_argument("--nchan", type=int, nargs="+", default=[1],
                        help="transforms a launch of the spread -parts probes and of "
                             "--spread3d --against")
    parser.add_argument("--against", default=None, metavar="SPREAD_3D_CU",
                        help="with --spread3d: time this spread_3d.cu against the shipped "
                             "one in turns at the chooser's pick, in place of the sweep")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a GPU")
    if args.gloo:
        probe_gloo()
        return 0
    if args.spread3d:
        probe_spread3d(args.seed, args.dtype, args.np, args.nchan, args.against, args.reps)
        return 0
    if args.spread2d:
        probe_spread2d(args.seed, args.dtype, args.np)
        return 0
    parts = [kind for kind in PARTS if getattr(args, kind + "_parts")]
    for kind in parts:
        probe_parts(kind, args.seed, args.dtype, args.np, args.m, args.reps,
                    nchans=args.nchan)
    if args.interp2d:
        probe_parts("interp2d", args.seed, args.dtype, args.np, args.m, args.reps,
                    designs=True)
    if parts or args.interp2d:
        return 0
    if args.weights:
        probe_weights(args.seed, args.np, args.m)
        return 0
    if args.exec_1d:
        probe_exec_1d(args.seed, args.reps)
        return 0
    if args.set_points:
        probe_set_points(args.seed, args.dim, args.dtype, args.np, args.reps)
        return 0
    if args.deconvolve:
        probe_deconvolve(args.seed, args.reps)
        return 0
    if args.alloc_window:
        probe_alloc_window(Path(args.root).resolve() if args.root else ROOT, args.alloc_window,
                           args.seed, args.seconds)
        return 0
    if args.interp1d_sweep:
        probe_interp1d_sweep(args.seed, args.dtype, args.np, args.reps)
        return 0
    if args.direct:
        probe_direct(args.seed, [d for d in args.dtype if d.startswith("complex")],
                     args.np or DIRECT_NP, min(args.reps, 3))
        return 0

    import nonuniformffts_tpu_torch as nufft
    from chip_smoke import cuda_time_ms, nvidia_smi_line
    from nonuniformffts_tpu_torch.ops.kernels import blocked
    from nonuniformffts_tpu_torch.ops.kernels.common import (
        MAX_SMEM_BYTES,
        VALUE_TYPES,
        spread_smem_bytes,
    )

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    for D in args.dim:
        shape = SHAPES[D]
        for name in args.dtype:
            dtype = np.dtype(name)
            plan0 = nufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5,
                                    spread_method="blocked", device=dev)
            _, sb, ncomp = VALUE_TYPES[plan0.dtype]
            dims = [plan0.block_dims] + [
                g for g in GEOMETRIES[D] if g != plan0.block_dims
                and all(n % b == 0 for n, b in zip(plan0.shape_over, g))
                and spread_smem_bytes(g, 4, 8, sb, ncomp) <= MAX_SMEM_BYTES
            ]
            for np_ in args.np or DEFAULT_NP[D]:
                gen = torch.Generator(device=dev).manual_seed(args.seed + np_)
                pts = torch.rand((D, np_), generator=gen, device=dev,
                                 dtype=plan0.real_dtype) * (2 * math.pi)
                vp = torch.randn((1, np_), generator=gen, device=dev, dtype=plan0.dtype)
                times = {g: [] for g in dims}
                for order in (dims, dims[::-1]):
                    for g in order:
                        plan = nufft.set_points(dataclasses.replace(plan0, block_dims=g), pts)
                        ms, out = cuda_time_ms(lambda: blocked.spread_blocked(plan, vp))
                        times[g].append(ms)
                        del plan, out
                        torch.cuda.empty_cache()
                print(json.dumps({
                    "dim": D, "dtype": name, "np": np_, "chosen": list(plan0.block_dims),
                    "spread_ms": {"x".join(map(str, g)): sum(t) / len(t)
                                  for g, t in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
