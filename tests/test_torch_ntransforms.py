"""Many transforms over shared points on the CPU: the port at C = 5 and 8
against the JAX package's reference path, grouped passes
(``Plan.transform_chunk``, the JAX package's ``cr_chunk``) against one pass,
callbacks that mix transforms, the timer's labels under grouping, the memory
model that chooses the group size on the card, and one case against JAX's
own grouped blocked kernels (interpret mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch import plan as tplan
from torch_port_utils import random_complex, real_dtype, rel_err

torch.set_num_threads(1)

DTYPES = [np.complex64, np.complex128, np.float32, np.float64]
SHAPES = [(40,), (16, 12), (10, 12, 8)]
NP = 250
# Port against JAX: the same algorithm, summed in another order
# (test_torch_exec.py:TOL_JAX, by the bytes of the real scalar).
TOL_JAX = {4: 1e-5, 8: 1e-10}
# Grouped against one pass: the same kernels on the same transforms; only
# cuFFT's batch, and the order of 32-bit sums with it, differs.
TOL_GROUPED = {4: 1e-6, 8: 1e-12}
GIB = 1 << 30


def _tol(table, dtype):
    return table[real_dtype(dtype).itemsize]


def _inputs(rng, dtype, shape, spectral_shape, C, np_=NP):
    """Points in the plan's real dtype, (C, Np) values of the plan's dtype
    and a (C,) + spectral_shape spectrum of its complex dtype."""
    real = real_dtype(dtype)
    pts = rng.uniform(0, 2 * np.pi, (len(shape), np_)).astype(real)
    v = random_complex(rng, np.complex128, (C, np_))
    v = (v if np.dtype(dtype).kind == "c" else v.real).astype(dtype)
    cdt = np.complex64 if real == np.float32 else np.complex128
    return pts, v, random_complex(rng, cdt, (C,) + spectral_shape)


def _port_plan(dtype, shape, C, method="blocked", **kw):
    return tnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C,
                            spread_method=method, device="cpu", **kw)


def _both(plan, v, u, callbacks=None):
    return (tnufft.exec_type1(plan, v, callbacks=callbacks),
            tnufft.exec_type2(plan, u, callbacks=callbacks))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("C", [5, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_many_transforms_match_jax_reference(shape, C, dtype):
    """The port's blocked plan at C = 5 and 8, run in one pass and in
    groups of 3, against the JAX package's reference path, transform by
    transform."""
    tp = _port_plan(dtype, shape, C)
    pts, v, u = _inputs(np.random.default_rng(C), dtype, shape, tp.spectral_shape, C)
    tp = tnufft.set_points(tp, pts)
    jp = jnufft.set_points(jnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C,
                                            spread_method="reference"), pts)
    ju1, jv2 = np.asarray(jnufft.exec_type1(jp, v)), np.asarray(jnufft.exec_type2(jp, u))
    tol = _tol(TOL_JAX, dtype)
    for plan in (tp, dataclasses.replace(tp, transform_chunk=3)):
        u1, v2 = (x.numpy() for x in _both(plan, v, u))
        assert u1.shape == ju1.shape == (C,) + tp.spectral_shape
        assert v2.shape == jv2.shape == (C, NP)
        for c in range(C):
            assert rel_err(u1[c], ju1[c]) <= tol
            assert rel_err(v2[c], jv2[c]) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("method", ["blocked", "reference"])
@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_grouped_matches_one_pass(chunk, method, shape, dtype):
    """Type 1 and type 2 at C = 8 with ``transform_chunk`` forced to 1, 2
    and 3 (8, 4 and 3 groups) against the same plan in one pass."""
    C = 8
    plan = _port_plan(dtype, shape, C, method)
    pts, v, u = _inputs(np.random.default_rng(chunk), dtype, shape, plan.spectral_shape, C)
    plan = tnufft.set_points(plan, pts)
    assert plan.transform_chunk is None  # CPU plans run one pass
    grouped = dataclasses.replace(plan, transform_chunk=chunk)
    assert len(tplan.transform_groups(C, chunk)) == -(-C // chunk)
    u1, v2 = _both(plan, v, u)
    g1, g2 = _both(grouped, v, u)
    assert g1.dtype == u1.dtype and g1.shape == u1.shape
    assert g2.dtype == v2.dtype and g2.shape == v2.shape
    tol = _tol(TOL_GROUPED, dtype)
    assert rel_err(g1.numpy(), u1.numpy()) <= tol
    assert rel_err(g2.numpy(), v2.numpy()) <= tol


def _mixing_callbacks(C, np_):
    """A uniform callback under which transform c takes a share of
    transform c + 1 (mod C), and a nonuniform one that does the same with
    another share and a per-point weight."""
    w = torch.linspace(0.5, 1.5, np_, dtype=torch.float64)

    def uniform(ws, idx):
        return tuple(ws[c] + 0.25 * ws[(c + 1) % C] for c in range(C))

    def nonuniform(vs, n):
        return tuple((vs[c] - 0.5 * vs[(c + 1) % C]) * w[n].to(vs[c].dtype) for c in range(C))

    return tnufft.NUFFTCallbacks(nonuniform=nonuniform, uniform=uniform), w


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(16, 12), (10, 12, 8)], ids=str)
@pytest.mark.parametrize("chunk", [1, 3])
def test_mixing_callbacks_grouped_match_one_pass(chunk, shape, dtype):
    """Callbacks that mix transforms see every transform at once whether the
    plan runs in groups or not: grouped equals one pass, and both equal the
    mixing applied by hand around the transforms without callbacks."""
    C = 5
    plan = _port_plan(dtype, shape, C)
    pts, v, u = _inputs(np.random.default_rng(3), dtype, shape, plan.spectral_shape, C)
    plan = tnufft.set_points(plan, pts)
    cb, w = _mixing_callbacks(C, NP)
    u1, v2 = _both(plan, v, u, cb)
    g1, g2 = _both(dataclasses.replace(plan, transform_chunk=chunk), v, u, cb)
    tol = _tol(TOL_GROUPED, dtype)
    assert rel_err(g1.numpy(), u1.numpy()) <= tol
    assert rel_err(g2.numpy(), v2.numpy()) <= tol

    def mix(x, share):
        return x + share * torch.roll(x, -1, dims=0)

    wt = w.to(plan.real_dtype)
    by_hand1 = mix(tnufft.exec_type1(plan, mix(torch.as_tensor(v), -0.5) * wt), 0.25)
    by_hand2 = mix(tnufft.exec_type2(plan, mix(torch.as_tensor(u), 0.25)), -0.5) * wt
    # A callback applied group by group would see no transform of the next
    # group: these limits are far below what that would change.
    hand_tol = 1e-5 if real_dtype(dtype) == np.float32 else 1e-12
    assert rel_err(g1.numpy(), by_hand1.numpy()) <= hand_tol
    assert rel_err(g2.numpy(), by_hand2.numpy()) <= hand_tol


@pytest.mark.parametrize("with_callbacks", [False, True], ids=["plain", "callbacks"])
def test_timer_labels_add_up_over_groups(with_callbacks):
    """Under grouping each stage runs under today's label once a group; a
    grouped type 2's scaling (and uniform callback) runs once more under
    "(1) deconvolve + pad", a grouped type 1's uniform callback once more
    under "(3) deconvolve + truncate"; the nonuniform callbacks run once; each
    exec's "(4) group copy" once a group."""
    C, chunk = 8, 3
    timer = tnufft.Timer(synchronise=True)
    plan = _port_plan(np.complex128, (16, 12), C, timer=timer)
    pts, v, u = _inputs(np.random.default_rng(9), np.complex128, (16, 12),
                        plan.spectral_shape, C)
    plan = dataclasses.replace(tnufft.set_points(plan, pts), transform_chunk=chunk)
    cb = _mixing_callbacks(C, NP)[0] if with_callbacks else None
    timer.reset()
    _both(plan, v, u, cb)
    groups = -(-C // chunk)
    want = {
        "exec_type1": 1, "exec_type2": 1,
        "exec_type1/(1) spreading": groups, "exec_type1/(2) forward FFT": groups,
        "exec_type1/(3) deconvolve + truncate": groups + with_callbacks,
        "exec_type2/(1) deconvolve + pad": groups + 1,
        "exec_type2/(2) backward FFT": groups, "exec_type2/(3) interpolation": groups,
        "exec_type1/(4) group copy": groups, "exec_type2/(4) group copy": groups,
    }
    if with_callbacks:
        want["exec_type1/(0) nonuniform callback"] = 1
        want["exec_type2/(4) nonuniform callback"] = 1
    assert dict(timer.counts) == want
    for top in ("exec_type1", "exec_type2"):
        inner = sum(t for k, t in timer.times.items() if k.startswith(top + "/"))
        assert inner <= timer.times[top]


# ---------------------------------------------------------------------------
# The memory model (plan.py:choose_transform_chunk) on fabricated cards
# ---------------------------------------------------------------------------


def _model_args(dtype, shape, sigma):
    p = tnufft.PlanNUFFT(dtype, shape, m=4, sigma=sigma, spread_method="blocked", device="cpu")
    return p.shape_over, p.spectral_shape_over, p.spectral_shape, p.dtype


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_chooser_none_when_everything_fits(dtype):
    args = _model_args(dtype, (256, 256, 256), 1.5)
    assert tplan.choose_transform_chunk(*args, 1, 1_000_000, 85 * 10**9) is None
    assert tplan.choose_transform_chunk(*args, 2, 1_000_000, 85 * 10**9) is None
    assert tplan.choose_transform_chunk(*_model_args(dtype, (64, 48), 2.0), 32, 10**5,
                                        85 * 10**9) is None


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("device_gib", [0.001, 1, 4])
def test_chooser_never_below_one(device_gib, dtype):
    args = _model_args(dtype, (256, 256, 256), 2.0)
    g = tplan.choose_transform_chunk(*args, 32, 16_777_216, int(device_gib * GIB))
    assert g is not None and g >= 1


@pytest.mark.parametrize("method", ["blocked", "reference"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape,sigma", [((256, 256, 256), 1.5), ((256, 256, 256), 2.0),
                                         ((4096, 4096), 1.5), ((1 << 20,), 1.5)], ids=str)
def test_chooser_fits_the_budget(shape, sigma, dtype, method):
    """The chosen group is the largest whose modelled working set fits the
    budget, on cards of 16, 40, 80 and 141 GiB, C from 1 to 64."""
    args = _model_args(dtype, shape, sigma)
    kw = dict(point_state_bytes=200 << 20, spread_method=method, chunk_size=1 << 16)
    for device in (16 * GIB, 40 * GIB, 80 * GIB, 141 * GIB):
        budget = int(tplan.TRANSFORM_MEMORY_FRACTION * device)
        for C in (1, 3, 8, 32, 64):
            ws = tplan.transform_working_set(*args, C, 1_000_000, **kw)
            g = tplan.choose_transform_chunk(*args, C, 1_000_000, device, **kw)
            if g is None:  # one pass; a single transform cannot be split
                assert ws.total(C) <= budget or C == 1
                continue
            assert 1 <= g < C
            assert g == 1 or ws.total(g) <= budget
            assert ws.total(g + 1) > budget


def test_chooser_groups_sigma2_complex128_c32_on_85_gb():
    """sigma = 2, complex128, C = 32 at 256^3 holds 68.7 GB of grid alone:
    it cannot run in one pass on an 85 GB card."""
    args = _model_args(np.complex128, (256, 256, 256), 2.0)
    assert args[0] == (512, 512, 512)
    g = tplan.choose_transform_chunk(*args, 32, 1_000_000, 85 * 10**9)
    assert g is not None and len(tplan.transform_groups(32, g)) > 1
    assert tplan.transform_working_set(*args, 32, 1_000_000).total(g) <= 0.75 * 85e9


@pytest.mark.parametrize("C,chunk", [(8, 3), (32, 5), (32, 12), (7, 7), (7, 1), (5, None)])
def test_transform_groups_nearly_equal(C, chunk):
    groups = tplan.transform_groups(C, chunk)
    assert groups[0].start == 0 and groups[-1].stop == C
    assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))
    sizes = {g.stop - g.start for g in groups}
    assert len(sizes) <= 2 and max(sizes) - min(sizes) <= 1
    assert len(groups) == (1 if chunk is None else -(-C // chunk))
    assert max(sizes) <= (C if chunk is None else chunk)


def test_set_points_chooses_on_cuda_plans_only(monkeypatch):
    """``set_points`` leaves a CPU plan's ``transform_chunk`` as it is, and
    chooses a CUDA plan's from the card's total memory (here a fabricated
    512 MiB card) and the point state the plan holds."""
    C, shape = 16, (64, 64, 64)
    plan = _port_plan(np.complex128, shape, C)
    pts, _, _ = _inputs(np.random.default_rng(1), np.complex128, shape, plan.spectral_shape, C)
    cpu = tnufft.set_points(plan, pts)
    assert cpu.transform_chunk is None
    assert tnufft.set_points(dataclasses.replace(plan, transform_chunk=4), pts).transform_chunk == 4

    class Props:
        total_memory = GIB // 2

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    on_card = dataclasses.replace(cpu, device=torch.device("cuda"))
    chosen = tplan.with_transform_chunk(on_card).transform_chunk
    want = tplan.choose_transform_chunk(
        cpu.shape_over, cpu.spectral_shape_over, cpu.spectral_shape, cpu.dtype, C, NP, GIB // 2,
        point_state_bytes=tplan.point_state_bytes(cpu))
    assert chosen == want and chosen is not None and 1 <= chosen < C
    assert tplan.point_state_bytes(cpu) == sum(
        t.numel() * t.element_size()
        for t in (cpu.cells_sorted, cpu.fracs_sorted, cpu.sort_perm, cpu.pstarts))
    direct = dataclasses.replace(on_card, spread_method="direct")
    assert tplan.with_transform_chunk(direct).transform_chunk is None


def test_grouped_matches_jax_cr_chunk():
    """The port in groups of one transform against the JAX blocked plan
    with ``cr_chunk`` forced to 2 channels (one complex component a pass,
    its yz-form kernels in interpret mode), C = 3 in 2D."""
    C, shape, dtype = 3, (16, 12), np.complex64
    jp = jnufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C,
                          spread_method="blocked", interpret=True)
    assert jp.kernel_form == "yz"
    jp = dataclasses.replace(jp, cr_chunk=2)
    tp = dataclasses.replace(_port_plan(dtype, shape, C), transform_chunk=1)
    pts, v, u = _inputs(np.random.default_rng(31), dtype, shape, tp.spectral_shape, C, 300)
    jp = jnufft.set_points(jp, pts)
    assert jp.cr_chunk == 2  # 6 channels in 3 passes
    u1, v2 = (x.numpy() for x in _both(tnufft.set_points(tp, pts), v, u))
    ju1, jv2 = np.asarray(jnufft.exec_type1(jp, v)), np.asarray(jnufft.exec_type2(jp, u))
    for c in range(C):
        assert rel_err(u1[c], ju1[c]) <= TOL_JAX[4]
        assert rel_err(v2[c], jv2[c]) <= TOL_JAX[4]
