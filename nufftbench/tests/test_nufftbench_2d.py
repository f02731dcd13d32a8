"""The 2D deployment, ``nufft2d_4096_c128``, and its cell
``c128.2d4096.rho1.moving``: found by name with its files and metrics; the
comparison that decides ``correct``, driven through whole runs of the
port's 2D moving mix on the CPU at a small grid (sound runs pass, the
lower-precision control and the planted faults fail); the reader of
``value_gather_ms``; and the roofline's count at the cell's shapes, worked
out by hand."""

import json
from pathlib import Path

import pytest

from nufftbench import harness, roofline
from nufftbench.shapes import shapes_of

ROOT = Path(__file__).resolve().parents[2]
CELL = "c128.2d4096.rho1.moving"
TINY = (32, 40)
SEED = 2**31 + 2424
#: What the cell reports traced: every per-layer metric but the chunk sum.
PER_LAYER = {"set_points_ms", "exec_self_ms", "spread_ms", "spread_roofline_pct", "fft_ms",
             "deconvolve_ms", "interp_ms", "interp_roofline_pct", "device_idle_pct",
             "library_load_s", "grid_zero_ms", "value_gather_ms"}
GATHER = "exec_type1/(1) spreading/value gather"


def _run(cell, seed=SEED, dtype=None):
    return harness.run_cell(cell, seed, 0.3, False, "cpu", dtype=dtype)


def test_the_cell_is_found():
    cell = harness.load_cell(ROOT, CELL)
    assert cell.chips == 1
    assert cell.config["shape"] == [4096, 4096] and cell.config["dtype"] == "complex128"
    assert (cell.config["m"], cell.config["sigma"], cell.config["tolerance"]) == (4, 1.5, 1e-6)
    assert cell.traffic == json.loads((ROOT / "nufftbench/traffic/rho1.moving.json").read_text())
    assert {m["name"] for m in cell.per_layer} == PER_LAYER
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "step_ms", "step_p95_ms",
                                                   "peak_mem_gib"}
    assert set(cell.limits["limits"]) == {"t1_rel_l2", "t2_rel_l2"}
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_configuration_differs_from_the_3d_rows_in_its_grid_alone():
    """The same protocol as ``nufft3d_256_c128``: only the grid (2^24 modes
    either way), the source's words and the assumptions differ, and nothing
    is cut."""
    cfgs = ROOT / "nufftbench" / "configs"
    two = json.loads((cfgs / "nufft2d_4096_c128.json").read_text())
    three = json.loads((cfgs / "nufft3d_256_c128.json").read_text())
    assert two.keys() == three.keys()
    assert {k for k in two if two[k] != three[k]} == {"shape", "source", "assumed"}
    assert 4096**2 == 256**3 == 2**24
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == "nufft2d_4096_c128"]
    assert entry["reduced"] == [] and entry["file"] == "nufftbench/configs/nufft2d_4096_c128.json"
    (gather,) = [m for m in bench["per_layer"] if m["name"] == "value_gather_ms"]
    assert CELL in gather["workloads"]
    assert not {"c128.rho10.moving", "c128.rho10.chunked4"} & set(gather["workloads"])


def test_sound_run_is_correct(tiny):
    res = _run(tiny(CELL, shape=TINY))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert len(res["run"]["checked_steps"]) >= 1


def test_control_fails(tiny):
    """The program at complex64, the precision below the configuration's."""
    cell = tiny(CELL, shape=TINY)
    res = _run(cell, dtype=harness.LOWER[cell.config["dtype"]])
    assert not res["correct"]
    assert any(c["value"] > 10 * c["limit"] for c in res["checks"].values()), res["checks"]


@pytest.mark.parametrize("which", ["exec_type1", "exec_type2"])
def test_altered_answer_fails(tiny, monkeypatch, which):
    import nonuniformffts_tpu_torch as nufft

    def alter(x):
        x = x.clone()
        flat = x.reshape(-1)
        flat[flat.numel() // 3] *= 1.5
        return x

    real = getattr(nufft, which)
    monkeypatch.setattr(nufft, which, lambda plan, x: alter(real(plan, x)))
    res = _run(tiny(CELL, shape=TINY))
    check = res["checks"][harness.CHECKS[which]]
    assert not res["correct"] and check["value"] > check["limit"]


def test_unchanged_state_fails(tiny, monkeypatch):
    """``set_points`` that returns the plan it was given once points are
    set: the steps run on stale points."""
    import nonuniformffts_tpu_torch as nufft

    real = nufft.set_points
    monkeypatch.setattr(nufft, "set_points",
                        lambda plan, pts: plan if plan.num_points is not None else real(plan, pts))
    assert not _run(tiny(CELL, shape=TINY))["correct"]


def test_half_the_points_left_out_fails(tiny, monkeypatch):
    import nonuniformffts_tpu_torch as nufft

    real = nufft.exec_type1

    def half(plan, v):
        v = v.clone()
        v[:, v.shape[1] // 2:] = 0
        return real(plan, v)

    monkeypatch.setattr(nufft, "exec_type1", half)
    assert not _run(tiny(CELL, shape=TINY))["correct"]


def test_value_gather_reader():
    """The Timer's ``value gather`` a timed step, in ms; None where the
    program opened no such section, or no step was timed."""
    cell = harness.load_cell(ROOT, CELL)
    shapes = shapes_of(cell.config, cell.traffic)
    read = harness.metric_reader("value_gather_ms")
    times = {"exec_type1": 4.0, "exec_type1/(1) spreading": 2.5,
             "exec_type1/(1) spreading/grid zero": 0.1, GATHER: 0.36}
    assert read(harness.Record(shapes=shapes, timer_times=times, timer_steps=1000)) == \
        pytest.approx(0.36)
    no_gather = {k: v for k, v in times.items() if k != GATHER}
    assert read(harness.Record(shapes=shapes, timer_times=no_gather, timer_steps=1000)) is None
    assert read(harness.Record(shapes=shapes, timer_times=times, timer_steps=0)) is None
    assert read(harness.Record(shapes=shapes)) is None


def test_traced_cpu_run_reads_no_gather(tiny):
    """On the CPU the plain spread opens no ``value gather``: the traced run
    leaves the metric out and is still correct."""
    res = harness.run_cell(tiny(CELL, shape=TINY), SEED, 0.4, True, "cpu")
    assert res["correct"], res["checks"]
    assert "value_gather_ms" not in res["metrics"] and "spread_ms" in res["metrics"]


def test_roofline_at_the_cells_shapes():
    """By hand: grid 6,144^2 (1.5 x 4,096, smooth); a point 16 B of value and
    16 B of coordinates; 2 axes x 8 taps x 14 operations (Horner, degree 7),
    64 tap products, 64 multiply-adds of each of 2 scalars; 16 B a node."""
    cell = harness.load_cell(ROOT, CELL)
    s = shapes_of(cell.config, cell.traffic)
    assert s.grid_over == (6144, 6144) and s.num_points == 16_777_216 and s.ndim == 2
    per_point = 2 * 8 * 14 + 64 + 64 * 2 * 2
    assert per_point == 544
    nbytes = 16_777_216 * 32 + 6144 * 6144 * 16
    assert nbytes == 1_140_850_688
    flops = 16_777_216 * 544
    assert flops == 9_126_805_504
    for work in (roofline.spread_work(s), roofline.interp_work(s)):
        assert work == (nbytes, flops)
        t, which = roofline.bound_s(work)
        assert which == "bytes"
        assert 1e3 * t == pytest.approx(0.340_552_4, rel=1e-6)
    assert 1e3 * flops / roofline.PEAK_FLOPS == pytest.approx(0.136_221, rel=1e-5)
