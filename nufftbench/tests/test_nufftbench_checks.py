"""The comparison that decides ``correct``, driven through whole runs on
the CPU at a small size: sound runs pass, the lower-precision control and
each fault the cells can have fail."""

import math

import pytest
import torch

from nufftbench import harness

CELLS = ["c128.rho1.moving", "f64.rho1.moving", "c128.rho0p1.fixed", "f64.rho0p1.fixed"]
SEED = 2**31 + 4242


def _run(cell, seed=SEED, dtype=None):
    return harness.run_cell(cell, seed, 0.3, False, "cpu", dtype=dtype)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    res = _run(tiny(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert len(res["run"]["checked_steps"]) >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tiny, name):
    """The program at the precision below the configuration's."""
    cell = tiny(name)
    res = _run(cell, dtype=harness.LOWER[cell.config["dtype"]])
    assert not res["correct"]
    assert any(c["value"] > 10 * c["limit"] for c in res["checks"].values()), res["checks"]


def _alter_one(x):
    """The output with one answer changed where it is produced."""
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
    res = _run(tiny(name))
    assert not res["correct"]
    assert res["checks"][harness.CHECKS[which]]["value"] > res["checks"][harness.CHECKS[which]]["limit"]


@pytest.mark.parametrize("name", ["c128.rho1.moving", "f64.rho1.moving"])
def test_unchanged_state_fails(tiny, monkeypatch, name):
    """``set_points`` that returns the plan it was given once points are set:
    the steps run on stale points."""
    import nonuniformffts_tpu_torch as nufft

    real = nufft.set_points
    monkeypatch.setattr(nufft, "set_points",
                        lambda plan, pts: plan if plan.num_points is not None else real(plan, pts))
    res = _run(tiny(name))
    assert not res["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_points_left_out_fails(tiny, monkeypatch, name):
    import nonuniformffts_tpu_torch as nufft

    real = nufft.exec_type1

    def half(plan, v):
        v = v.clone()
        v[:, v.shape[1] // 2:] = 0
        return real(plan, v)

    monkeypatch.setattr(nufft, "exec_type1", half)
    assert not _run(tiny(name))["correct"]


def test_failed_steps_are_not_correct(tiny, monkeypatch):
    import nonuniformffts_tpu_torch as nufft

    calls = {"n": 0}
    real = nufft.exec_type2

    def flaky(plan, u):
        calls["n"] += 1
        if calls["n"] == harness.WARMUP_STEPS + 1:  # the window's first step
            raise RuntimeError("out of memory")
        return real(plan, u)

    monkeypatch.setattr(nufft, "exec_type2", flaky)
    res = _run(tiny("f64.rho0p1.fixed"))
    assert res["failed"] == 1 and not res["correct"]
    assert "out of memory" in res["error"]


def test_missing_outputs_count_as_infinite(tiny):
    cell = tiny("c128.rho0p1.fixed")
    from nufftbench.traffic import Traffic

    t = Traffic(cell.config, cell.traffic, 1, "cpu")
    gaps = harness.check_outputs(cell, t, {}, torch.device("cpu"))
    assert all(math.isinf(v) for v in gaps.values())
    gaps = harness.check_outputs(cell, t, {3: {"exec_type1": torch.full(
        (1, 16, 16, 16), float("nan"), dtype=torch.complex128)}}, torch.device("cpu"))
    assert math.isinf(gaps["t1_rel_l2"]) and math.isinf(gaps["t2_rel_l2"])
