"""Groups of transforms on the paths beside the plain plans, on the CPU:
points-chunked plans (``ChunkedPlan.transform_chunk``) grouped against one
pass and against the JAX package's ``ChunkedPlanNUFFT``, and the memory
model that chooses the group size on the card for the chunked plans and
for ranks that share a card (fabricated cards, as in
``test_torch_ntransforms.py``).  The point-sharded and spatial paths'
groups run in the rank processes of ``test_torch_parallel.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nonuniformffts_tpu as jnufft
import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch import chunked
from nonuniformffts_tpu_torch import plan as tplan
from nonuniformffts_tpu_torch.parallel import comm
from torch_port_utils import random_complex, random_points, real_dtype, rel_err

torch.set_num_threads(1)

DTYPES = [np.complex64, np.complex128, np.float32, np.float64]
C, K, NP, GROUP = 5, 3, 400, 2
# Against JAX's chunked plan (test_torch_chunked.py:TOL), and grouped
# against one pass: the same kernels on the same transforms, only the
# FFT's batch differs, by the bytes of the real scalar.
TOL_JAX = {4: 1e-5, 8: 1e-12}
TOL_GROUPED = {4: 1e-6, 8: 1e-15}
GIB = 1 << 30


def _tol(table, dtype):
    return table[real_dtype(dtype).itemsize]


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, len(shape), NP, dtype)
    v = random_complex(rng, np.complex128, (C, NP))
    v = (v if np.dtype(dtype).kind == "c" else v.real).astype(dtype)
    return pts, v


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("method", ["blocked", "reference"])
@pytest.mark.parametrize("shape", [(16, 12, 10), (256,)], ids=str)
def test_chunked_groups_match_one_pass_and_jax(shape, method, dtype):
    """A chunked plan of K = 3 chunks and C = 5 transforms with its group
    size forced to 2 (groups of 2, 2 and 1): equal to the same plan in one
    pass, and to the JAX package's chunked plan on its reference path.  In
    1D each chunk's spread stores its interior cells, so each needs a
    zeroed grid of its own, one group wide."""
    pts, v = _inputs(shape, dtype, seed=len(shape))
    kw = dict(m=4, sigma=1.5, ntransforms=C)
    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=K, spread_method=method, device="cpu",
                                **kw), pts)
    assert cpl.transform_chunk is None  # CPU plans run one pass
    grouped = dataclasses.replace(cpl, transform_chunk=GROUP)
    assert len(tplan.transform_groups(C, GROUP)) == 3
    jcpl = jnufft.set_points_chunked(
        jnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=K, spread_method="reference", **kw), pts)
    ju = np.asarray(jnufft.exec_type1_chunked(jcpl, v))
    jv2 = np.asarray(jnufft.exec_type2_chunked(jcpl, ju))
    u, g1 = (tnufft.exec_type1_chunked(p, v) for p in (cpl, grouped))
    v2, g2 = (tnufft.exec_type2_chunked(p, ju) for p in (cpl, grouped))
    assert g1.shape == u.shape == ju.shape and g1.dtype == u.dtype
    assert g2.shape == v2.shape == jv2.shape == (C, NP) and g2.dtype == v2.dtype
    assert rel_err(g1.numpy(), u.numpy()) <= _tol(TOL_GROUPED, dtype)
    assert rel_err(g2.numpy(), v2.numpy()) <= _tol(TOL_GROUPED, dtype)
    for c in range(C):
        assert rel_err(g1[c].numpy(), ju[c]) <= _tol(TOL_JAX, dtype)
        assert rel_err(g2[c].numpy(), jv2[c]) <= _tol(TOL_JAX, dtype)


def test_chunked_groups_keep_callbacks_whole():
    """Callbacks that mix transforms see every transform at once on a
    grouped chunked plan: grouped equals one pass."""
    shape, dtype = (16, 12, 10), np.complex128
    pts, v = _inputs(shape, dtype, seed=8)
    w = torch.linspace(0.5, 1.5, NP, dtype=torch.float64)
    cb = tnufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple((vs[c] - 0.5 * vs[(c + 1) % C]) * w[n] for c in range(C)),
        uniform=lambda ws, idx: tuple(ws[c] + 0.25 * ws[(c + 1) % C] for c in range(C)))
    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(dtype, shape, nchunks=K, m=4, sigma=1.5, ntransforms=C,
                                spread_method="blocked", device="cpu"), pts)
    grouped = dataclasses.replace(cpl, transform_chunk=GROUP)
    u = tnufft.exec_type1_chunked(cpl, v, callbacks=cb)
    assert rel_err(tnufft.exec_type1_chunked(grouped, v, callbacks=cb).numpy(),
                   u.numpy()) <= TOL_GROUPED[8]
    assert rel_err(tnufft.exec_type2_chunked(grouped, u, callbacks=cb).numpy(),
                   tnufft.exec_type2_chunked(cpl, u, callbacks=cb).numpy()) <= TOL_GROUPED[8]


# ---------------------------------------------------------------------------
# The memory model on fabricated cards
# ---------------------------------------------------------------------------


def _fake_card(monkeypatch, total_memory):
    class Props:
        pass

    Props.total_memory = total_memory
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)


def test_chunked_chooser_counts_accumulator_and_every_chunk(monkeypatch):
    """``set_points_chunked``'s choice on a (fabricated, 512 MiB) card: the
    template's model with all the points, the point state of all K chunks
    and one more grid a transform (the type-1 accumulator).  Without the
    accumulator, or with one chunk's state, it would choose more."""
    Cm, shape, np_ = 16, (64, 64, 64), 30_000
    rng = np.random.default_rng(11)
    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(np.complex128, shape, nchunks=K, m=4, sigma=1.5,
                                ntransforms=Cm, spread_method="blocked", device="cpu"),
        random_points(rng, 3, np_, np.complex128))
    assert cpl.transform_chunk is None
    _fake_card(monkeypatch, GIB // 2)
    on_card = dataclasses.replace(
        cpl, template=dataclasses.replace(cpl.template, device=torch.device("cuda")))
    chosen = chunked.with_transform_chunk(on_card).transform_chunk
    states = [tplan.point_state_bytes(p) for p in cpl.plans]
    assert all(s > 0 for s in states)
    t = cpl.template
    args = (t.shape_over, t.spectral_shape_over, t.spectral_shape, t.dtype, Cm, np_)

    def choose(**kw):
        return tplan.choose_transform_chunk(*args, GIB // 2, **kw)

    assert chosen == choose(point_state_bytes=sum(states), extra_grids=1)
    assert chosen is not None and 1 <= chosen < Cm
    assert chosen < choose(point_state_bytes=sum(states))
    with_acc = tplan.transform_working_set(*args, point_state_bytes=sum(states), extra_grids=1)
    without = tplan.transform_working_set(*args, point_state_bytes=states[0])
    assert with_acc.per_transform - without.per_transform == 64 * 64 * 64 * 16 * 1.5 ** 3
    assert with_acc.fixed - without.fixed == sum(states[1:])
    # A caller's size survives set_points_chunked on the CPU; the card's
    # choice replaces it.
    forced = dataclasses.replace(cpl, transform_chunk=3)
    assert chunked.with_transform_chunk(forced).transform_chunk == 3
    on_card_forced = dataclasses.replace(on_card, transform_chunk=3)
    assert chunked.with_transform_chunk(on_card_forced).transform_chunk == chosen


def test_chunked_direct_plans_choose_nothing(monkeypatch):
    rng = np.random.default_rng(12)
    cpl = tnufft.set_points_chunked(
        tnufft.ChunkedPlanNUFFT(np.complex128, (16, 12), nchunks=K, ntransforms=4,
                                spread_method="direct", device="cpu"),
        random_points(rng, 2, 50, np.complex128))
    _fake_card(monkeypatch, 1 << 20)
    on_card = dataclasses.replace(
        cpl, template=dataclasses.replace(cpl.template, device=torch.device("cuda")))
    assert chunked.with_transform_chunk(on_card).transform_chunk is None


@pytest.mark.parametrize("method", ["blocked", "reference"])
def test_ranks_sharing_a_card_plan_with_their_share(monkeypatch, method):
    """k ranks of a group on one fabricated card, made to hold 12 of the 32
    transforms, each choose from ``total_memory / k``: two ranks get half
    the budget, and smaller groups."""
    Cm, shape = 32, (64, 64, 64)
    plan = tnufft.PlanNUFFT(np.complex128, shape, m=4, sigma=1.5, ntransforms=Cm,
                            spread_method=method, chunk_size=1 << 12, device="cpu")
    cpu = tnufft.set_points(plan, random_points(np.random.default_rng(13), 3, 5_000,
                                                np.complex128))
    ws = tplan.transform_working_set(**tplan.model_arguments(cpu))
    card = int(ws.total(12) / tplan.TRANSFORM_MEMORY_FRACTION) + 1
    _fake_card(monkeypatch, card)
    on_card = dataclasses.replace(cpu, device=torch.device("cuda"))
    assert tplan.device_share_bytes(on_card.device, 2) == card // 2
    chosen = {k: tplan.with_transform_chunk(on_card, ranks_on_device=k).transform_chunk
              for k in (1, 2, 4)}
    for k, g in chosen.items():
        assert g == tplan.choose_transform_chunk(device_bytes=card // k,
                                                 **tplan.model_arguments(cpu))
    assert chosen[1] == tplan.with_transform_chunk(on_card).transform_chunk == 12
    assert chosen[4] < chosen[2] < chosen[1]
    for k in (2, 4):
        budget = int(tplan.TRANSFORM_MEMORY_FRACTION * (card // k))
        assert chosen[k] == 1 or ws.total(chosen[k]) <= budget
        assert budget < ws.total(chosen[k] + 1)


def test_ranks_sharing_counts_host_and_device():
    """The census' count: the rows naming this rank's host and device."""
    keys = torch.tensor([[7, 0], [7, 0], [7, 1], [9, 0], [7, 0]])
    assert comm.ranks_sharing(keys, torch.tensor([7, 0])) == 3
    assert comm.ranks_sharing(keys, torch.tensor([7, 1])) == 1
    assert comm.ranks_sharing(keys, torch.tensor([9, 0])) == 1
    key = comm.device_key(torch.device("cpu"))
    assert key.dtype == torch.int64 and key.shape == (2,) and int(key[1]) == -1
