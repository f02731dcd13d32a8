"""The two cells added beside the protocol's first four: the 32-coil MRI cell
in complex64 (``c64x32.rho0p1.fixed``) and the rho = 10 moving cell
(``c128.rho10.moving``).  On the CPU at a small size: their files are found
by name, a sound run is correct, the bfloat16 control (``control_bf16.py``)
and altered answers fail, and ``grid_zero_ms`` reads the program's section
(which the card's spread opens; on the CPU it reads nothing)."""

import pytest
import torch

from nufftbench import control_bf16, harness
from nufftbench.tests.conftest import ROOT

CELLS = ["c64x32.rho0p1.fixed", "c128.rho10.moving"]
SEED = 2**31 + 2020
#: The small size, at the cells' own densities: 51 points over 32 coils,
#: and 5,120 moving points.
SHAPE = (8, 8, 8)


def _cell(tiny, name):
    return tiny(name, shape=SHAPE)


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.3, trace, "cpu")


def test_files_are_found():
    cell = harness.load_cell(ROOT, "c64x32.rho0p1.fixed")
    assert cell.config["dtype"] == "complex64" and cell.config["shape"] == [256, 256, 256]
    assert cell.traffic["ntransforms"] == 32 and cell.traffic["motion"] == "fixed"
    assert cell.traffic["execs"] == ["exec_type2", "exec_type1"]
    assert set(cell.limits["limits"]) == {"t1_rel_l2", "t2_rel_l2"}
    names = [m["name"] for m in cell.per_layer]
    assert "set_points_ms" not in names and "grid_zero_ms" in names
    assert "spread_roofline_pct" in names and "interp_roofline_pct" in names
    cell = harness.load_cell(ROOT, "c128.rho10.moving")
    assert cell.config["dtype"] == "complex128"
    assert cell.traffic["density"] == 10.0 and cell.traffic["motion"] == "moving"
    assert {"set_points_ms", "grid_zero_ms"} <= {m["name"] for m in cell.per_layer}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "step_ms", "step_p95_ms",
                                                     "peak_mem_gib"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_sound_run_is_correct(tiny, name, trace):
    res = _run(_cell(tiny, name), trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and len(res["run"]["checked_steps"]) >= 1
    if trace:  # the plain spread the CPU runs opens no grid zero: nothing to read
        assert "grid_zero_ms" not in res["metrics"] and "spread_ms" in res["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_bf16_control_fails(tiny, name):
    """The program on values and spectrum rounded through bfloat16."""
    res = control_bf16.run_rounded(_cell(tiny, name), SEED, 0.3, False, "cpu")
    assert not res["correct"]
    assert all(c["value"] > 10 * c["limit"] for c in res["checks"].values()), res["checks"]


def test_bf16_rounding_keeps_8_bits():
    x = torch.randn(1000, dtype=torch.complex64)
    y = control_bf16.through_bf16(x)
    assert y.dtype == x.dtype and not torch.equal(x, y)
    for a, b in ((x.real, y.real), (x.imag, y.imag)):
        assert float(((a - b).abs() / a.abs()).max()) <= 2.0**-8


def _alter_one(x):
    x = x.clone()
    flat = x.reshape(-1)
    flat[flat.numel() // 3] *= 1.5
    return x


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("which", ["exec_type1", "exec_type2"])
def test_altered_answer_fails(tiny, monkeypatch, name, which):
    import nonuniformffts_tpu_torch as nufft

    real = getattr(nufft, which)
    monkeypatch.setattr(nufft, which, lambda plan, x: _alter_one(real(plan, x)))
    res = _run(_cell(tiny, name))
    check = res["checks"][harness.CHECKS[which]]
    assert not res["correct"] and check["value"] > check["limit"]


def test_one_coil_left_out_fails(tiny, monkeypatch):
    """Type 1 that drops the last coil's values: one transform of 32 wrong."""
    import nonuniformffts_tpu_torch as nufft

    real = nufft.exec_type1

    def drop_last(plan, v):
        v = v.clone()
        v[-1] = 0
        return real(plan, v)

    monkeypatch.setattr(nufft, "exec_type1", drop_last)
    assert not _run(_cell(tiny, "c64x32.rho0p1.fixed"))["correct"]


TIMER = {
    "exec_type1": 1.90,
    "exec_type1/(1) spreading": 1.50,
    "exec_type1/(1) spreading/grid zero": 0.046,
    "exec_type1/(2) forward FFT": 0.20,
    "exec_type1/(3) deconvolve + truncate": 0.16,
    "exec_type1/(4) group copy": 0.02,
    "exec_type2": 1.40,
    "exec_type2/(1) deconvolve + pad": 0.20,
    "exec_type2/(2) backward FFT": 0.19,
    "exec_type2/(3) interpolation": 0.97,
    "exec_type2/(4) group copy": 0.01,
}


def _record(times):
    cell = harness.load_cell(ROOT, "c64x32.rho0p1.fixed")
    from nufftbench.shapes import shapes_of

    return harness.Record(shapes=shapes_of(cell.config, cell.traffic), timer_times=times,
                          timer_steps=10)


def test_grid_zero_reads_its_section():
    read = harness.metric_reader("grid_zero_ms")
    assert read(_record(TIMER)) == pytest.approx(4.6)
    no_zero = {k: v for k, v in TIMER.items() if not k.endswith("grid zero")}
    assert read(_record(no_zero)) is None
    # the spreading it lies in still counts it
    assert harness.metric_reader("spread_ms")(_record(TIMER)) == pytest.approx(150.0)


def test_exec_self_subtracts_group_copies_not_grid_zero():
    """``exec_self_ms`` subtracts every depth-1 section, the group copies
    too; the grid zero lies inside the spreading."""
    read = harness.metric_reader("exec_self_ms")
    stages = sum(v for k, v in TIMER.items() if k.count("/") == 1)
    assert read(_record(TIMER)) == pytest.approx(1e3 * (1.90 + 1.40 - stages) / 10)
