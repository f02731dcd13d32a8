"""The direct-path deployment, ``nufft3d_256_c128_direct``, and its cell
``c128.direct.rho1e-4.moving``: the exact-sum reference
(``references/direct.py``) against brute-force NumPy sums; the port's direct
plan against the reference; the comparison that decides ``correct``, driven
through whole runs of the moving mix on the CPU at a small grid (sound runs
pass, the lower-precision control and the planted faults fail); the three
readers of the direct path's metrics; and the count of the exact sums at
the cell's shapes, worked out by hand."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from nufftbench import harness, roofline, roofline_direct
from nufftbench.references.direct import Reference
from nufftbench.shapes import shapes_of

ROOT = Path(__file__).resolve().parents[2]
CELL = "c128.direct.rho1e-4.moving"
TINY = (16, 16, 16)
#: At 16^3 the cell's rho = 1e-4 gives no point; 0.05 gives 205.
TINY_DENSITY = 0.05
SEED = 2**31 + 2727
PER_LAYER = {"set_points_ms", "exec_self_ms", "device_idle_pct", "direct_ms",
             "direct_factor_ms", "direct_roofline_pct"}


def _config(shape, dtype="complex128"):
    return {"shape": list(shape), "dtype": dtype}


def _brute(shape, x, v, u):
    """Type 1 and type 2 as their definitions' sums over every mode in
    FFTW order (float64 NumPy)."""
    ks = [np.fft.fftfreq(n, 1.0 / n) for n in shape]
    K = np.stack(np.meshgrid(*ks, indexing="ij"), -1).reshape(-1, len(shape))
    ph = K @ x
    t1 = (np.exp(-1j * ph) @ v.T).T.reshape((-1,) + tuple(shape))
    return t1, u.reshape(len(u), -1) @ np.exp(1j * ph)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(shape, npts, C, seed):
    gen = torch.Generator().manual_seed(seed)
    # unfolded coordinates: the reference folds them itself
    x = torch.rand((len(shape), npts), generator=gen, dtype=torch.float64) * 6 * math.pi
    x -= 2 * math.pi
    v = torch.randn((C, npts), generator=gen, dtype=torch.complex128)
    u = torch.randn((C,) + tuple(shape), generator=gen, dtype=torch.complex128)
    return x, v, u


# -- the reference -----------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
@pytest.mark.parametrize("shape,C", [((8, 8, 8), 1), ((16, 16, 16), 1), ((8, 8, 8), 2),
                                     ((12, 10, 16), 1), ((16, 20), 1), ((32,), 2)], ids=str)
def test_reference_against_brute_force_sums(shape, C, seed, monkeypatch):
    """Both types within 1e-12: two float64 evaluations of the same sums,
    apart only by rounding (about 1e-15 here).  The chunks are cut to 37
    points, so the sums run over several."""
    from nufftbench.references import direct as ref_mod

    monkeypatch.setattr(ref_mod, "CHUNK_ELEMENTS", 37 * math.prod(shape[:-1]))
    x, v, u = _inputs(shape, 150, C, seed)
    ref = Reference(_config(shape), "cpu")
    assert ref.step == 37
    t1, t2 = ref.type1(x, v), ref.type2(x, u)
    assert t1.shape == (C,) + shape and t2.shape == (C, 150)
    assert t1.dtype == t2.dtype == torch.complex128
    e1, e2 = _brute(shape, x.numpy(), v.numpy(), u.numpy())
    assert _rel(t1, e1) < 1e-12 and _rel(t2, e2) < 1e-12


def test_reference_refuses_real_data():
    with pytest.raises(NotImplementedError, match="halved last axis"):
        Reference(_config((8, 8), "float64"), "cpu")


def test_reference_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    Reference(_config((8, 8)), "cpu")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


# -- the port's direct plan against the reference ----------------------------

#: complex128: both are exact sums in float64, apart by rounding (~1e-15);
#: complex64: the plan computes in complex128 and rounds its output to
#: complex64 (2^-24 relative a value), and is given complex64 inputs.
PORT_TOL = {np.complex128: 1e-12, np.complex64: 1e-5}


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_port_direct_plan_against_the_reference(dtype):
    import nonuniformffts_tpu_torch as nufft

    x, v, u = _inputs(TINY, 300, 2, 31)
    plan = nufft.set_points(nufft.PlanNUFFT(dtype, TINY, spread_method="direct", ntransforms=2,
                                            device="cpu"), x)
    vt = v.to(torch.complex64 if dtype == np.complex64 else torch.complex128)
    ut = u.to(vt.dtype)
    got1, got2 = nufft.exec_type1(plan, vt), nufft.exec_type2(plan, ut)
    ref = Reference(_config(TINY), "cpu")
    assert _rel(got1.to(torch.complex128), ref.type1(x, vt)) < PORT_TOL[dtype]
    assert _rel(got2.to(torch.complex128), ref.type2(x, ut)) < PORT_TOL[dtype]


# -- the cell ------------------------------------------------------------------


def _tiny_cell():
    cell = harness.load_cell(ROOT, CELL)
    cell.config = dict(cell.config, shape=list(TINY))
    cell.traffic = dict(cell.traffic, density=TINY_DENSITY)
    return cell


def _run(cell, seed=SEED, dtype=None):
    return harness.run_cell(cell, seed, 0.3, False, "cpu", dtype=dtype)


def test_the_cell_is_found():
    cell = harness.load_cell(ROOT, CELL)
    assert cell.chips == 1
    assert cell.config["shape"] == [256, 256, 256] and cell.config["dtype"] == "complex128"
    assert (cell.config["spread_method"], cell.config["reference"]) == ("direct", "direct")
    assert cell.traffic == {"density": 1e-4, "motion": "moving", "max_displacement_cells": 1.0,
                            "execs": ["exec_type1", "exec_type2"], "ntransforms": 1}
    assert shapes_of(cell.config, cell.traffic).num_points == 1678
    assert {m["name"] for m in cell.per_layer} == PER_LAYER
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "step_ms", "step_p95_ms",
                                                   "peak_mem_gib"}
    assert set(cell.limits["limits"]) == {"t1_rel_l2", "t2_rel_l2"}


def test_configuration_differs_from_the_blocked_rows_in_its_path_alone():
    """The same protocol row as ``nufft3d_256_c128``: only the path, its
    reference, the source's words and the assumptions differ, and nothing
    is cut."""
    cfgs = ROOT / "nufftbench" / "configs"
    direct = json.loads((cfgs / "nufft3d_256_c128_direct.json").read_text())
    blocked = json.loads((cfgs / "nufft3d_256_c128.json").read_text())
    assert direct.keys() == blocked.keys()
    assert {k for k in direct if direct[k] != blocked[k]} == {"spread_method", "reference",
                                                              "source", "assumed"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == "nufft3d_256_c128_direct"]
    assert entry["reduced"] == []
    # the cell is in no blocked-path metric's list
    for m in bench["per_layer"]:
        assert (CELL in m["workloads"]) == (m["name"] in PER_LAYER), m["name"]


def test_sound_run_is_correct():
    res = _run(_tiny_cell())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and len(res["run"]["checked_steps"]) >= 1
    assert all(c["value"] < 1e-12 for c in res["checks"].values()), res["checks"]


def test_control_fails():
    """The program at complex64: its values and spectrum rounded, its
    output rounded."""
    res = _run(_tiny_cell(), dtype=harness.LOWER["complex128"])
    assert not res["correct"]
    assert all(c["value"] > 10 * c["limit"] for c in res["checks"].values()), res["checks"]


def _one_point_left_out(nufft, monkeypatch):
    real1, real2 = nufft.exec_type1, nufft.exec_type2

    def type1(plan, v):
        v = v.clone()
        v[:, 7] = 0
        return real1(plan, v)

    def type2(plan, u):
        out = real2(plan, u).clone()
        out[:, 7] = 0
        return out

    monkeypatch.setattr(nufft, "exec_type1", type1)
    monkeypatch.setattr(nufft, "exec_type2", type2)
    return ("t1_rel_l2", "t2_rel_l2")


def _one_axis_sign_flipped(nufft, monkeypatch):
    real = nufft.set_points
    flip = torch.tensor([1.0, -1.0, 1.0], dtype=torch.float64)[:, None]
    monkeypatch.setattr(nufft, "set_points", lambda plan, pts: real(plan, pts * flip))
    return ("t1_rel_l2", "t2_rel_l2")


def _type2_of_the_previous_step(nufft, monkeypatch):
    """``exec_type2`` answers on the plan of the step before."""
    real_set, real2 = nufft.set_points, nufft.exec_type2
    plans = []

    def set_points(plan, pts):
        plans.append(real_set(plan, pts))
        return plans[-1]

    monkeypatch.setattr(nufft, "set_points", set_points)
    monkeypatch.setattr(nufft, "exec_type2", lambda plan, u: real2(plans[-2] if len(plans) > 1
                                                                   else plan, u))
    return ("t2_rel_l2",)


@pytest.mark.parametrize("plant", [_one_point_left_out, _one_axis_sign_flipped,
                                   _type2_of_the_previous_step],
                         ids=lambda f: f.__name__.strip("_"))
def test_planted_faults_fail(monkeypatch, plant):
    import nonuniformffts_tpu_torch as nufft

    faulty = plant(nufft, monkeypatch)
    res = _run(_tiny_cell())
    assert not res["correct"]
    for name in faulty:
        assert res["checks"][name]["value"] > 1e3 * res["checks"][name]["limit"], res["checks"]


# -- the readers and the count -------------------------------------------------


def _record(**kw):
    cell = harness.load_cell(ROOT, CELL)
    return harness.Record(shapes=shapes_of(cell.config, cell.traffic), **kw)


def read(name, rec):
    return harness.metric_reader(name)(rec)


TIMER = {
    "set_points": 0.02,
    "exec_type1": 0.50,
    "exec_type1/(1) direct NUDFT": 0.48,
    "exec_type1/(1) direct NUDFT/phase factors": 0.06,
    "exec_type1/(1) direct NUDFT/product": 0.40,
    "exec_type2": 0.46,
    "exec_type2/(1) direct NUDFT": 0.44,
    "exec_type2/(1) direct NUDFT/phase factors": 0.05,
    "exec_type2/(1) direct NUDFT/product": 0.37,
}


def test_readers_per_step():
    rec = _record(timer_times=TIMER, timer_steps=100)
    assert read("direct_ms", rec) == pytest.approx(9.2)
    assert read("direct_factor_ms", rec) == pytest.approx(1.1)
    bound = roofline.bound_s(roofline_direct.sums_work(rec.shapes))[0]
    assert read("direct_roofline_pct", rec) == pytest.approx(100 * 2 * bound / 0.0092)
    assert 0 < read("direct_roofline_pct", rec) < 100
    # the stages' children are not counted again as stages
    assert read("exec_self_ms", rec) == pytest.approx(0.4)


def test_readers_of_a_type_alone():
    """A mix of one exec: the bound of one type over its stage."""
    times = {k: v for k, v in TIMER.items() if not k.startswith("exec_type2")}
    rec = _record(timer_times=times, timer_steps=10)
    assert read("direct_ms", rec) == pytest.approx(48.0)
    bound = roofline.bound_s(roofline_direct.sums_work(rec.shapes))[0]
    assert read("direct_roofline_pct", rec) == pytest.approx(100 * bound / 0.048)


def test_readers_find_nothing_elsewhere():
    """A blocked plan's Timer, a program without the sections, no steps:
    no reading, and no error."""
    blocked = {"exec_type1": 1.0, "exec_type1/(1) spreading": 0.9}
    without = {k: v for k, v in TIMER.items() if "phase factors" not in k and "product" not in k}
    for times, steps in ((blocked, 10), ({}, 0), (TIMER, 0)):
        rec = _record(timer_times=times, timer_steps=steps)
        for name in ("direct_ms", "direct_factor_ms", "direct_roofline_pct"):
            assert read(name, rec) is None, (name, times)
    rec = _record(timer_times=without, timer_steps=10)
    assert read("direct_factor_ms", rec) is None and read("direct_ms", rec) is not None


def test_count_at_the_cells_shapes():
    """1,678 points on 256^3 in complex128, a type: 8 x 1,678 x 256^3 =
    2.25e11 operations, 3.36 ms at 67 TFLOP/s; bytes: the values (16 a
    point), the coordinates (24 a point) and the spectrum (16 a mode)."""
    s = _record().shapes
    nbytes, flops = roofline_direct.sums_work(s)
    assert flops == 8 * 1678 * 256**3 == pytest.approx(2.2522e11, rel=1e-4)
    assert nbytes == 1678 * 16 + 1678 * 24 + 256**3 * 16
    t, by = roofline.bound_s((nbytes, flops))
    assert by == "operations" and t == pytest.approx(3.3615e-3, rel=1e-4)
    # the count reads the shapes alone: C transforms count C times
    s4 = shapes_of(_config((256, 256, 256)) | {"m": 4, "sigma": 1.5, "kernel": "k",
                                               "kernel_evalmode": "e"},
                   {"density": 1e-4, "ntransforms": 4})
    assert roofline_direct.sums_work(s4)[1] == 4 * flops
