"""The window taps K3 at ``set_points``: for every window the kernels do not
evaluate themselves (all but (B)KB FastApproximation), ``set_points`` on
the blocked path stores the sorted points' ``(D, 2M, Np)`` taps on the plan
(``Plan.wtaps_sorted``, from the plain version on the CPU), and the
transforms read them without evaluating them again.  Every builder of
blocked point state carries the table: ``set_points`` (and through it the
point-sharded mode and the NFFT adapter), the spatial mode's slab plans
and ``dataclasses.replace`` copies.  The transforms still match the JAX
package's blocked plans (interpret mode), to the tolerances of
``test_torch_window_modes.py``."""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.ops.kernels import blocked
from nonuniformffts_tpu_torch.ops.kernels import common as kcommon
from torch_port_utils import (
    EVALMODE_NAMES,
    KERNEL_NAMES,
    evalmode_pair,
    kernel_pair,
    random_complex,
    real_dtype,
    rel_err,
)

torch.set_num_threads(1)

TOL = {4: 1e-5, 8: 1e-12}
WINDOWS = [(k, e) for k in KERNEL_NAMES for e in EVALMODE_NAMES]
# The windows whose taps come from K3.
TAP_WINDOWS = [w for w in WINDOWS if not (
    w[0] in ("KaiserBesselKernel", "BackwardsKaiserBesselKernel") and w[1] == "FastApproximation")]


def _plan(dtype, shape, window, m=4, sigma=2.0, **kw):
    return tnufft.PlanNUFFT(dtype, shape, m=m, sigma=sigma,
                            kernel=getattr(tnufft, window[0])(),
                            kernel_evalmode=getattr(tnufft, window[1])(),
                            spread_method="blocked", device="cpu", **kw)


def _points(rng, dtype, D, np_):
    pts = rng.uniform(-2 * np.pi, 4 * np.pi, (D, np_)).astype(real_dtype(dtype))
    pts[:, :4] = np.nextafter(real_dtype(dtype).type(2 * np.pi), real_dtype(dtype).type(0))
    return pts


@pytest.mark.parametrize("dtype", [np.complex64, np.float64], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(40,), (16, 12), (8, 10, 12)], ids=str)
@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_set_points_stores_the_plain_taps(window, shape, dtype):
    """A K3 window's plan holds the plain version's taps of its sorted
    points, ``(D, 2M, Np)`` in the plan's real dtype; a (B)KB
    FastApproximation plan holds none (its kernels evaluate the taps)."""
    plan = _plan(dtype, shape, window)
    plan = tnufft.set_points(plan, _points(np.random.default_rng(len(shape)), dtype,
                                           len(shape), 250))
    if window not in TAP_WINDOWS:
        assert plan.wtaps_sorted is None
        return
    taps = plan.wtaps_sorted
    assert taps.shape == (len(shape), 8, 250) and taps.dtype == plan.real_dtype
    assert torch.equal(taps, blocked.window_weights_blocked_plain(plan))
    # A copy with other execution fields keeps the table; the reference
    # path's points replace it by none.
    assert dataclasses.replace(plan, chunk_size=64).wtaps_sorted is taps
    ref = tnufft.set_points(dataclasses.replace(plan, spread_method="reference"),
                            _points(np.random.default_rng(1), dtype, len(shape), 10))
    assert ref.wtaps_sorted is None


def _no_taps(*args, **kwargs):
    raise AssertionError("the window taps were evaluated after set_points")


@pytest.mark.parametrize("window", TAP_WINDOWS, ids=lambda w: f"{w[0]}-{w[1]}")
def test_transforms_read_the_stored_taps(window, monkeypatch):
    """After ``set_points`` neither transform evaluates the taps again (the
    K3 wrapper, its plain version and the tap function raise if called),
    the kernels' launch arguments point at the stored table, and type 1
    and type 2 match the JAX package's blocked plan (1D, N = 40, m = 4,
    sigma = 2, the dtype turning with the window)."""
    i = TAP_WINDOWS.index(window)
    dtype = [np.complex64, np.complex128, np.float64][i % 3]
    shape = (40,)
    tp = _plan(dtype, shape, window)
    (_, jk), (_, je) = kernel_pair(window[0]), evalmode_pair(window[1])
    jp = jnufft.PlanNUFFT(dtype, shape, m=4, sigma=2.0, kernel=jk, kernel_evalmode=je,
                          spread_method="blocked", interpret=True)
    assert jp.kernel_form == "yz" and tp.shape_over == jp.shape_over
    rng = np.random.default_rng(60 + i)
    pts = _points(rng, dtype, 1, 300)
    v = random_complex(rng, np.complex128, 300)
    v = (v if np.dtype(dtype).kind == "c" else v.real).astype(dtype)
    u = random_complex(rng, np.complex64 if real_dtype(dtype) == np.float32 else np.complex128,
                       tp.spectral_shape)
    tp = tnufft.set_points(tp, pts)
    for name in ("window_weights_blocked", "window_weights_blocked_plain", "window_weights"):
        monkeypatch.setattr(blocked, name, _no_taps)
    monkeypatch.setattr(kcommon, "window_weights", _no_taps)
    coefs, taps, ncoef = blocked._launch_args(torch.zeros(1, 300, dtype=tp.dtype), tp, "values")
    assert (coefs, taps, ncoef) == (0, tp.wtaps_sorted.data_ptr(), 0)
    u1, v2 = tnufft.exec_type1(tp, v).numpy(), tnufft.exec_type2(tp, u).numpy()
    jpp = jnufft.set_points(jp, pts)
    ju1, jv2 = np.asarray(jnufft.exec_type1(jpp, v)), np.asarray(jnufft.exec_type2(jpp, u))
    tol = TOL[real_dtype(dtype).itemsize]
    assert rel_err(u1, ju1) <= tol and rel_err(v2, jv2) <= tol


def test_plan_without_stored_taps_refuses_the_kernels():
    """A K3 window's blocked point state without its table (built by hand,
    not by ``set_points``) cannot reach a kernel: the argument check
    names ``set_points``."""
    plan = tnufft.set_points(_plan(np.complex128, (40,), ("GaussianKernel", "Direct")),
                             _points(np.random.default_rng(2), np.complex128, 1, 50))
    bare = dataclasses.replace(plan, wtaps_sorted=None)
    with pytest.raises(ValueError, match="set_points"):
        blocked._launch_args(torch.zeros(1, 50, dtype=torch.complex128), bare, "values")
    wrong = dataclasses.replace(plan, wtaps_sorted=plan.wtaps_sorted[:, :, :49])
    with pytest.raises(ValueError, match="window taps of shape"):
        blocked._launch_args(torch.zeros(1, 50, dtype=torch.complex128), wrong, "values")


def test_window_packed_once_a_plan(monkeypatch):
    """``Plan.window`` packs the window's scalars once a plan object, however
    often ``set_points`` and the kernels' wrappers read it, and a plan made
    from it by ``dataclasses.replace`` with another window packs its own:
    no stale pack is carried over."""
    from nonuniformffts_tpu_torch import plan as plan_module
    from nonuniformffts_tpu_torch.ops.windows import window_pack

    packed = []
    monkeypatch.setattr(plan_module, "window_pack",
                        lambda *a: packed.append(a) or window_pack(*a))
    tp = _plan(np.complex128, (16, 12), ("BackwardsKaiserBesselKernel", "FastApproximation"))
    assert all(tp.window is tp.window for _ in range(3)) and len(packed) == 1
    for _ in range(3):
        assert blocked.kernel_coefs(tp)[1] == tp.coefs.shape[-1]
        blocked.check_kernel_support(tp)
    assert len(packed) == 1
    direct = dataclasses.replace(tp, evalmode=tnufft.Direct())
    assert direct.window == window_pack(direct.kernel_data, direct.evalmode) != tp.window
    assert blocked.kernel_coefs(direct) == (None, 0) and len(packed) == 2


@pytest.mark.parametrize("window", ["gauss", "spline"])
def test_nfft_adapter_plan_holds_the_taps(window):
    """The NFFT adapter's blocked plan (its ``set_points``, on the card by
    default) holds the table of its window (the Gaussian, the B-spline)."""
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 120))
    p = tnufft.plan_nfft(x, (16, 12), window=window, device="cpu", spread_method="blocked")
    assert p.plan.wtaps_sorted is not None
    assert torch.equal(p.plan.wtaps_sorted, blocked.window_weights_blocked_plain(p.plan))


def test_spatial_slab_plan_holds_the_taps():
    """The spatial mode's slab plan (one gloo rank in this process) holds
    its window's table, and its transforms equal a single-device plan's."""
    from nonuniformffts_tpu_torch.parallel import SpatialNUFFT

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        kw = dict(m=4, sigma=2.0, kernel=tnufft.GaussianKernel(), kernel_evalmode=tnufft.Direct())
        sp = SpatialNUFFT(np.complex128, (16, 12, 16), device="cpu", **kw)
        rng = np.random.default_rng(4)
        pts = rng.uniform(0, 2 * np.pi, (3, 200))
        st = sp.set_points(pts)
        assert st.local.wtaps_sorted is not None
        assert torch.equal(st.local.wtaps_sorted, blocked.window_weights_blocked_plain(st.local))
        v_ch = rng.standard_normal((1, 2, 200))
        u = sp.exec_type1(st, v_ch)
        plan = tnufft.set_points(tnufft.PlanNUFFT(np.complex128, (16, 12, 16),
                                                  spread_method="blocked", device="cpu",
                                                  **kw), pts)
        u_ref = tnufft.exec_type1_channels(plan, torch.from_numpy(v_ch))
        assert rel_err(u.numpy(), u_ref.numpy()) <= 1e-12
    finally:
        dist.destroy_process_group()
