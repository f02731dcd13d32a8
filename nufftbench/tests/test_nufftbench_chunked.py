"""The points-chunked cell (``c128.rho10.chunked4``): a mix's ``nchunks``
runs ``ChunkedPlanNUFFT`` through ``set_points_chunked`` and
``exec_type{1,2}_chunked``.  On the CPU at small sizes: the key is read and
checked, the chunked steps agree with the plain plan's and with the
reference, a traced run reads the program's stage sections and
``chunk_sum_ms``, and the control and each fault the cell can have fail."""

import pytest
import torch

from nufftbench import harness, trace
from nufftbench.tests.conftest import ROOT
from nufftbench.traffic import Traffic

NAME = "c128.rho10.chunked4"
SEED = 2**31 + 2424
CONFIG = {"shape": [16, 16, 16], "dtype": "complex128", "m": 4, "sigma": 1.5,
          "kernel": "BackwardsKaiserBesselKernel", "kernel_evalmode": "FastApproximation",
          "spread_method": "blocked", "reference": "nufft"}
MIX = {"density": 1.0, "motion": "moving", "max_displacement_cells": 1.0,
       "execs": ["exec_type1", "exec_type2"], "ntransforms": 1}
#: The per-layer metrics the cell reports: c128.rho10.moving's but
#: ``grid_zero_ms`` (under the synchronised Timer a chunk's grid zero waits
#: for the previous chunk's spread kernel), and the chunk sum.
PER_LAYER = {"set_points_ms", "exec_self_ms", "spread_ms", "spread_roofline_pct", "fft_ms",
             "deconvolve_ms", "interp_ms", "interp_roofline_pct", "device_idle_pct",
             "library_load_s", "chunk_sum_ms"}


def _cell(tiny):
    """The cell at 8^3: 5,120 moving points in four chunks."""
    return tiny(NAME, shape=(8, 8, 8))


def _run(cell, trace=False, dtype=None):
    return harness.run_cell(cell, SEED, 0.3, trace, "cpu", dtype=dtype)


def test_traffic_reads_nchunks():
    assert Traffic(CONFIG, MIX, 1, "cpu").nchunks == 1
    assert Traffic(CONFIG, dict(MIX, nchunks=3), 1, "cpu").nchunks == 3
    for bad in (0, -2):
        with pytest.raises(ValueError, match="nchunks"):
            Traffic(CONFIG, dict(MIX, nchunks=bad), 1, "cpu")


def test_the_cell_is_found():
    cell = harness.load_cell(ROOT, NAME)
    moving = harness.load_cell(ROOT, "c128.rho10.moving")
    assert cell.config == moving.config
    assert cell.traffic == dict(moving.traffic, nchunks=4)
    assert cell.chips == 1 and set(cell.limits["limits"]) == {"t1_rel_l2", "t2_rel_l2"}
    assert {m["name"] for m in cell.per_layer} == PER_LAYER
    assert {m["name"] for m in moving.per_layer} == PER_LAYER - {"chunk_sum_ms"} | {"grid_zero_ms"}
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in moving.end_to_end]


def _cell_of(mix):
    return harness.Cell(name="t", chips=1, config=CONFIG, traffic=mix, end_to_end=[],
                        per_layer=[], limits={"limits": {}})


@pytest.mark.parametrize("fixed", [False, True], ids=["moving", "fixed"])
def test_chunked_steps_match_the_plain_plan_and_the_reference(fixed):
    mix = dict(MIX, motion="fixed") if fixed else MIX
    plain_cell, chunked_cell = _cell_of(mix), _cell_of(dict(mix, nchunks=3))
    dev = torch.device("cpu")
    plain_t = Traffic(CONFIG, plain_cell.traffic, SEED, dev)
    chunked_t = Traffic(CONFIG, chunked_cell.traffic, SEED, dev)
    plain = harness.Steps(plain_cell, plain_t, dev, "complex128")
    steps = harness.Steps(chunked_cell, chunked_t, dev, "complex128")
    assert type(steps.plan).__name__ == "ChunkedPlan" and steps.plan.nchunks == 3
    assert type(plain.plan).__name__ == "Plan"
    limit = harness.load_cell(ROOT, NAME).limits["limits"]
    for k in (0, 5):
        a, b = plain(k), steps(k)
        # the chunks change only the order of the spread's float sums
        assert harness.rel_l2(b["exec_type1"], a["exec_type1"]) < 1e-13
        assert harness.rel_l2(b["exec_type2"], a["exec_type2"]) < 1e-13
        gaps = harness.check_outputs(chunked_cell, chunked_t, {k: b}, dev)
        plain_gaps = harness.check_outputs(plain_cell, plain_t, {k: a}, dev)
        for n in ("t1_rel_l2", "t2_rel_l2"):
            assert gaps[n] <= limit[n] and plain_gaps[n] <= limit[n]


def test_the_timer_leaves_chunked_outputs_bit_equal():
    """The traced run's chunked plan carries the timer; its steps give the
    plain chunked plan's outputs, bit for bit, with the program's stages
    under the exec sections the harness opens."""
    import nonuniformffts_tpu_torch as nufft

    cell = _cell_of(dict(MIX, nchunks=3))
    dev = torch.device("cpu")
    t = Traffic(CONFIG, cell.traffic, SEED, dev)
    timer = nufft.Timer(synchronise=True)
    plain = harness.Steps(cell, t, dev, "complex128")
    timed = harness.Steps(cell, t, dev, "complex128", timer=timer)
    for k in range(2):
        a, b = plain(k), timed(k)
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert timer.counts["set_points"] == 2 * 3
    for label in ("exec_type1", "exec_type1/(1) spreading", "exec_type1/(2) forward FFT",
                  "exec_type1/(3) deconvolve + truncate", "exec_type2",
                  "exec_type2/(1) deconvolve + pad", "exec_type2/(2) backward FFT",
                  "exec_type2/(3) interpolation"):
        assert timer.counts[label] == 2, label
    assert not any(n.startswith("(") for n in timer.times)


def test_traced_run_reports_the_cell_metrics(tiny):
    res = _run(_cell(tiny), trace=True)
    assert res["correct"], res["checks"]
    # no card, no device trace and no kernel library: the rest are read
    want = PER_LAYER - {"device_idle_pct", "library_load_s"}
    assert want <= set(res["metrics"]), sorted(res["metrics"])
    assert res["metrics"]["chunk_sum_ms"]["value"] > 0


def test_plain_mix_reports_no_chunk_sum(tiny):
    cell = tiny("c128.rho10.moving", shape=(8, 8, 8))
    cell.per_layer = harness.load_cell(ROOT, NAME).per_layer
    res = _run(cell, trace=True)
    assert res["correct"]
    assert "chunk_sum_ms" not in res["metrics"] and "spread_ms" in res["metrics"]


def test_sound_untraced_run_is_correct(tiny):
    res = _run(_cell(tiny))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and len(res["run"]["checked_steps"]) >= 1


def test_control_fails(tiny):
    """The chunked plan at complex64, the precision below the cell's."""
    res = _run(_cell(tiny), dtype="complex64")
    assert not res["correct"]
    assert all(c["value"] > 10 * c["limit"] for c in res["checks"].values()), res["checks"]


def _alter_one(x):
    x = x.clone()
    flat = x.reshape(-1)
    flat[flat.numel() // 3] *= 1.5
    return x


@pytest.mark.parametrize("which", ["exec_type1_chunked", "exec_type2_chunked"])
def test_altered_answer_fails(tiny, monkeypatch, which):
    import nonuniformffts_tpu_torch as nufft

    real = getattr(nufft, which)
    monkeypatch.setattr(nufft, which, lambda plan, x: _alter_one(real(plan, x)))
    res = _run(_cell(tiny))
    check = res["checks"][harness.CHECKS[which.removesuffix("_chunked")]]
    assert not res["correct"] and check["value"] > check["limit"]


def test_unchanged_state_fails(tiny, monkeypatch):
    """``set_points_chunked`` that returns the plan it was given once
    points are set: the steps run on stale points."""
    import nonuniformffts_tpu_torch as nufft

    real = nufft.set_points_chunked
    monkeypatch.setattr(nufft, "set_points_chunked",
                        lambda plan, pts: plan if plan.plans is not None else real(plan, pts))
    assert not _run(_cell(tiny))["correct"]


def test_half_the_points_left_out_fails(tiny, monkeypatch):
    import nonuniformffts_tpu_torch as nufft

    real = nufft.exec_type1_chunked

    def half(plan, v):
        v = v.clone()
        v[:, v.shape[1] // 2:] = 0
        return real(plan, v)

    monkeypatch.setattr(nufft, "exec_type1_chunked", half)
    assert not _run(_cell(tiny))["correct"]


def test_one_chunk_left_out_fails(tiny, monkeypatch):
    """Type 1 whose sum leaves the last chunk out."""
    import nonuniformffts_tpu_torch as nufft

    real = nufft.exec_type1_chunked

    def three(plan, v):
        v = v.clone()
        v[:, -plan.plans[-1].num_points:] = 0
        return real(plan, v)

    monkeypatch.setattr(nufft, "exec_type1_chunked", three)
    assert not _run(_cell(tiny))["correct"]


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _record(events, steps=2):
    from nufftbench.shapes import shapes_of

    return harness.Record(shapes=shapes_of(CONFIG, MIX), trace_events=events,
                          trace_steps=steps)


def _step(t0, corr0, spread_label="nufft:(1) spreading", adds=True):
    """One step's type 1 in a trace: two chunk spreads (a grid zero and a
    kernel each) and, on a chunked plan, their sum."""
    ev = [_x("nufftbench.exec_type1", "user_annotation", t0, 400),
          _x(spread_label, "user_annotation", t0 + 10, 300)]
    for i in range(2):
        t = t0 + 20 + 120 * i
        ev += [_x(spread_label + "/grid zero", "user_annotation", t, 20),
               _x("aten::zeros", "cpu_op", t + 1, 18),
               _x("cudaLaunchKernel", "cuda_runtime", t + 30, 5, corr=corr0 + i),
               _x("spread_3d_kernel", "kernel", t + 40, 70, corr=corr0 + i)]
        if adds and i == 1:
            ev += [_x("aten::add_", "cpu_op", t + 80, 10),
                   _x("cudaLaunchKernel", "cuda_runtime", t + 82, 5, corr=corr0 + 10),
                   _x("vectorized_elementwise_kernel", "kernel", t + 111, 7, corr=corr0 + 10)]
    # an add outside the spreading span: not the chunk sum
    ev += [_x("aten::add_", "cpu_op", t0 + 350, 10),
           _x("cudaLaunchKernel", "cuda_runtime", t0 + 352, 5, corr=corr0 + 20),
           _x("add_kernel", "kernel", t0 + 360, 30, corr=corr0 + 20)]
    return ev


def test_chunk_sum_reads_the_adds_inside_the_spreading():
    read = harness.metric_reader("chunk_sum_ms")
    window = [_x(trace.WINDOW, "user_annotation", 0, 2000)]
    events = window + _step(100, 1) + _step(1000, 100)
    # 7 us of the sum's kernel a step
    assert read(_record(events)) == pytest.approx(7e-3)
    # the exec's prefix, as a program that opens the exec section would have
    labelled = window + _step(100, 1, "nufft:exec_type1/(1) spreading")
    assert read(_record(labelled, steps=1)) == pytest.approx(7e-3)
    # a plain plan: no sum, nothing to read
    assert read(_record(window + _step(100, 1, adds=False))) is None
    assert read(_record(_step(100, 1))) is None  # no window
    assert read(_record(events, steps=0)) is None
    # a CPU trace, with no device operation: the adds' own time
    host = [e for e in events if e["cat"] in ("user_annotation", "cpu_op")]
    assert read(_record(host)) == pytest.approx(10e-3)
