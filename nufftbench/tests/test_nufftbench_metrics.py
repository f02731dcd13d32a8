"""The metric arithmetic of the readers in nufftbench/metrics/, on
synthetic records."""

import numpy as np
import pytest

from nufftbench import harness, roofline
from nufftbench.shapes import shapes_of

CONFIG = {"shape": [256, 256, 256], "dtype": "complex128", "m": 4, "sigma": 1.5,
          "kernel": "BackwardsKaiserBesselKernel", "kernel_evalmode": "FastApproximation"}
MIX = {"density": 1.0, "motion": "moving", "max_displacement_cells": 1.0,
       "execs": ["exec_type1", "exec_type2"], "ntransforms": 1}


def _record(**kw):
    return harness.Record(shapes=shapes_of(CONFIG, MIX), **kw)


def read(name, rec):
    return harness.metric_reader(name)(rec)


def test_step_ms_is_window_over_steps():
    times = [0.04] * 99 + [0.5]  # one stalled step
    rec = _record(step_times=times, window_s=4.51)
    assert read("step_ms", rec) == pytest.approx(1e3 * 4.51 / 100)


def test_step_p95_over_all_steps_with_a_stall():
    times = [0.040] * 90 + [0.041 + 0.001 * i for i in range(9)] + [2.0]
    rec = _record(step_times=times, window_s=sum(times))
    want = 1e3 * float(np.percentile(times, 95))
    assert read("step_p95_ms", rec) == pytest.approx(want)
    # the stall is past the 95th percentile of 100 steps; six stalls are not
    stalled = times[:94] + [2.0] * 6
    assert read("step_p95_ms", _record(step_times=stalled, window_s=1.0)) == pytest.approx(2000.0)


def test_no_steps_no_reading():
    rec = _record()
    assert read("step_ms", rec) is None and read("step_p95_ms", rec) is None
    assert read("peak_mem_gib", rec) is None
    for name in ("set_points_ms", "exec_self_ms", "spread_ms", "fft_ms", "deconvolve_ms",
                 "interp_ms", "spread_roofline_pct", "interp_roofline_pct", "device_idle_pct"):
        assert read(name, rec) is None, name


def test_peak_and_setup():
    rec = _record(peak_bytes=3 * 2**30, setup_s=7.5)
    assert read("peak_mem_gib", rec) == 3.0
    assert read("setup_s", rec) == 7.5


TIMER = {
    "set_points": 0.74,
    "exec_type1": 1.90,
    "exec_type1/(1) spreading": 1.50,
    "exec_type1/(2) forward FFT": 0.20,
    "exec_type1/(3) deconvolve + truncate": 0.16,
    "exec_type2": 1.40,
    "exec_type2/(1) deconvolve + pad": 0.20,
    "exec_type2/(2) backward FFT": 0.19,
    "exec_type2/(3) interpolation": 0.97,
}


def test_stage_readers_per_step():
    rec = _record(timer_times=TIMER, timer_steps=100)
    assert read("set_points_ms", rec) == pytest.approx(7.4)
    assert read("spread_ms", rec) == pytest.approx(15.0)
    assert read("fft_ms", rec) == pytest.approx(3.9)
    assert read("deconvolve_ms", rec) == pytest.approx(3.6)
    assert read("interp_ms", rec) == pytest.approx(9.7)
    # (1.90 + 1.40 - the six stages 3.22) / 100 steps
    assert read("exec_self_ms", rec) == pytest.approx(0.8)


def test_fixed_mix_has_no_set_points_reading():
    times = {k: v for k, v in TIMER.items() if k != "set_points"}
    assert read("set_points_ms", _record(timer_times=times, timer_steps=10)) is None


def test_rooflines_divide_the_shape_bound_by_the_stage():
    rec = _record(timer_times=TIMER, timer_steps=100)
    bound = roofline.bound_s(roofline.spread_work(rec.shapes))[0]
    assert read("spread_roofline_pct", rec) == pytest.approx(100 * bound / 0.015)
    bound = roofline.bound_s(roofline.interp_work(rec.shapes))[0]
    assert read("interp_roofline_pct", rec) == pytest.approx(100 * bound / 0.0097)
    assert 0 < read("spread_roofline_pct", rec) < 100


def test_device_idle():
    rec = _record(device={"busy_s": 1.8, "window_s": 2.0, "device_ops": [], "idle_gaps": []})
    assert read("device_idle_pct", rec) == pytest.approx(10.0)
    assert read("device_idle_pct", _record(device=None)) is None
