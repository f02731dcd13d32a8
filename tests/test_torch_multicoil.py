"""Many coils over one trajectory: a complex64 blocked plan with 32
transforms, in one pass and in forced groups, against the benchmark's plain
float64 reference (``nufftbench/references/nufft.py``), grouped against one
pass, and the Timer's labels for what the groups add: each exec's ``(4)
group copy``, and on the card the spread's ``grid zero`` and ``value
gather``.  The tests marked
``cuda`` skip without a card; the file imports no JAX, so on a GPU host:

    python -m pytest tests/test_torch_multicoil.py --noconftest -q
"""

import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch.plan import transform_groups

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from nufftbench.references.nufft import Reference  # noqa: E402

torch.set_num_threads(1)

C = 32
NP = 500
CHUNK = 5  # 7 groups of 32 transforms: 5, 5, 5, 5, 4, 4, 4
SHAPES = [(16, 16, 16), (16, 12, 20)]
CONFIG = {"dtype": "complex64", "m": 4, "sigma": 1.5,
          "kernel": "BackwardsKaiserBesselKernel", "kernel_evalmode": "FastApproximation"}
# A complex64 plan against the float64 reference: the plan rounds the
# coordinates to float32, a phase error of up to |k| 2 pi 2^-24 at the
# highest mode |k| = 10 of these grids, and stores float32 values and modes;
# its sums run in float64.  It reads 9.1-9.9e-7 on these inputs (5x room).
# Inputs rounded through bfloat16 (8 significant bits) read 1.65e-3.
TOL = 5e-6
#: The stage labels that the benchmark's metrics read, unchanged.
STAGES = ["exec_type1/(1) spreading", "exec_type1/(2) forward FFT",
          "exec_type1/(3) deconvolve + truncate", "exec_type2/(1) deconvolve + pad",
          "exec_type2/(2) backward FFT", "exec_type2/(3) interpolation"]
SET_POINTS = ["set_points", "set_points/(1) cell split", "set_points/(2) bin sort",
              "set_points/(3) sorted copies", "set_points/(4) window taps",
              "set_points/(5) transform groups"]
GRID_ZERO = "exec_type1/(1) spreading/grid zero"
VALUE_GATHER = "exec_type1/(1) spreading/value gather"
GROUP_COPY = ["exec_type1/(4) group copy", "exec_type2/(4) group copy"]


def _inputs(shape, seed=1):
    """float64 coordinates (as the benchmark passes them), (C, Np) complex64
    values and a (C,) + shape complex64 spectrum."""
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(0, 2 * np.pi, (3, NP)))

    def draw(size):
        return torch.complex(torch.as_tensor(rng.standard_normal(size)),
                             torch.as_tensor(rng.standard_normal(size))).to(torch.complex64)

    return pts, draw((C, NP)), draw((C,) + shape)


def _plan(shape, pts, chunk=None, device="cpu"):
    plan = tnufft.PlanNUFFT(np.complex64, shape, m=4, sigma=1.5, ntransforms=C,
                            spread_method="blocked", device=device)
    return dataclasses.replace(tnufft.set_points(plan, pts.to(device)), transform_chunk=chunk)


def _through_bf16(x):
    return torch.complex(x.real.to(torch.bfloat16).float(), x.imag.to(torch.bfloat16).float())


def _rel(got, want):
    got = got.to(want.dtype)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    """Inputs and the reference's outputs on one grid."""
    shape = request.param
    pts, v, u = _inputs(shape)
    ref = Reference(dict(CONFIG, shape=list(shape)), "cpu")
    return shape, pts, v, u, ref.type1(pts, v), ref.type2(pts, u)


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["one_pass", "groups"])
def test_32_coils_match_reference(case, chunk):
    shape, pts, v, u, want1, want2 = case
    plan = _plan(shape, pts, chunk)
    assert len(transform_groups(C, plan.transform_chunk)) == (1 if chunk is None else 7)
    assert _rel(tnufft.exec_type1(plan, v), want1) <= TOL
    assert _rel(tnufft.exec_type2(plan, u), want2) <= TOL


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["one_pass", "groups"])
def test_bf16_inputs_fail_the_tolerance(case, chunk):
    """The comparison sees a precision below the configuration's."""
    shape, pts, v, u, want1, want2 = case
    plan = _plan(shape, pts, chunk)
    assert _rel(tnufft.exec_type1(plan, _through_bf16(v)), want1) > 100 * TOL
    assert _rel(tnufft.exec_type2(plan, _through_bf16(u)), want2) > 100 * TOL


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_groups_equal_one_pass(shape):
    """The same functions a group: on the CPU the outputs are the same bits."""
    pts, v, u = _inputs(shape, seed=2)
    one, grouped = _plan(shape, pts), _plan(shape, pts, CHUNK)
    assert torch.equal(tnufft.exec_type1(one, v), tnufft.exec_type1(grouped, v))
    assert torch.equal(tnufft.exec_type2(one, u), tnufft.exec_type2(grouped, u))


def _timed_counts(chunk, method="blocked", device="cpu", shape=(16, 12, 20)):
    pts, v, u = _inputs(shape, seed=3)
    timer = tnufft.Timer(synchronise=True)
    plan = tnufft.PlanNUFFT(np.complex64, shape, m=4, sigma=1.5, ntransforms=C,
                            spread_method=method, device=device, timer=timer)
    plan = dataclasses.replace(tnufft.set_points(plan, pts.to(device)), transform_chunk=chunk)
    timer.reset()
    tnufft.exec_type2(plan, u.to(device))
    tnufft.exec_type1(plan, v.to(device))
    return dict(timer.counts)


def _want(groups, zero):
    """Each stage once a group, a grouped type 2's scaling once more, each
    exec's ``group copy`` once a group when there are groups, and the
    spread's ``grid zero`` and ``value gather`` once a group where ``zero``
    (on the card)."""
    want = {"exec_type1": 1, "exec_type2": 1, **dict.fromkeys(STAGES, groups)}
    if groups > 1:
        want.update(dict.fromkeys(GROUP_COPY, groups))
        want["exec_type2/(1) deconvolve + pad"] += 1
    if zero:
        want[GRID_ZERO] = want[VALUE_GATHER] = groups
    return want


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["one_pass", "groups"])
def test_group_copy_only_in_groups(chunk):
    """On the CPU: ``(4) group copy`` once a group in 7 groups, never in one
    pass; the plain spread opens no ``grid zero``."""
    groups = len(transform_groups(C, chunk))
    assert _timed_counts(chunk) == _want(groups, zero=False)


@pytest.mark.parametrize("method", ["reference", "direct"])
def test_no_new_labels_off_the_blocked_path(method):
    counts = _timed_counts(None, method)
    assert GRID_ZERO not in counts and not set(GROUP_COPY) & set(counts)
    assert VALUE_GATHER not in counts


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["one_pass", "groups"])
def test_grid_zero_on_the_card(card, chunk):
    """On the card the spread kernel's grid is zeroed in ``grid zero`` and
    its values gathered in ``value gather``, once a group each, inside the
    spreading; the results still meet the reference."""
    shape = (16, 12, 20)
    groups = len(transform_groups(C, chunk))
    assert _timed_counts(chunk, device=card) == _want(groups, zero=True)
    pts, v, u = _inputs(shape, seed=6)
    ref = Reference(dict(CONFIG, shape=list(shape)), "cpu")
    plan = _plan(shape, pts, chunk, device=card)
    assert _rel(tnufft.exec_type1(plan, v.to(card)).cpu(), ref.type1(pts, v)) <= TOL
    assert _rel(tnufft.exec_type2(plan, u.to(card)).cpu(), ref.type2(pts, u)) <= TOL


def test_existing_labels_unchanged():
    """The labels the benchmark's readers name (``nufftbench/metrics``),
    letter for letter, and ``set_points``' parts; the new one sits beside
    them."""
    shape = (16, 16, 16)
    pts, v, u = _inputs(shape, seed=4)
    timer = tnufft.Timer(synchronise=True)
    plan = tnufft.set_points(tnufft.PlanNUFFT(np.complex64, shape, m=4, sigma=1.5, ntransforms=C,
                                              spread_method="blocked", device="cpu",
                                              timer=timer), pts)
    tnufft.exec_type1(dataclasses.replace(plan, transform_chunk=CHUNK), v)
    tnufft.exec_type2(plan, u)
    assert set(timer.times) == {*SET_POINTS, "exec_type1", "exec_type2", *STAGES,
                                GROUP_COPY[0]}
    # exec_self_ms subtracts every depth-1 section: a group copy is one,
    # the grid zero lies inside the spreading.
    assert GROUP_COPY[0].count("/") == 1 and GRID_ZERO.startswith(STAGES[0] + "/")


def test_group_copies_are_profiler_spans():
    """Under ``torch.profiler`` each group copy is a ``nufft:`` span, with
    no timer attached."""
    shape = (16, 12, 20)
    pts, v, u = _inputs(shape, seed=5)
    plan = _plan(shape, pts, CHUNK)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tnufft.exec_type2(plan, u)
        tnufft.exec_type1(plan, v)
    spans = collections.Counter(e.name[len("nufft:"):] for e in prof.events()
                                if e.name.startswith("nufft:"))
    groups = len(transform_groups(C, CHUNK))
    assert all(spans[label] == groups for label in GROUP_COPY)
