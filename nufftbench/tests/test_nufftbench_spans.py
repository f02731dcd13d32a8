"""The reduction of the program's spans in a profiler trace
(nufftbench/spans.py) on synthetic Chrome-trace events, the readings of
nufftbench/span_profile.py, the library-load reader, and one profiled
stretch on the CPU at a small size."""

import pytest

from nufftbench import harness, span_profile, spans, trace


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


P = spans.SPAN_PREFIX
# One step in a window of 1000 us: set_points with a bin sort that reads two
# values to the host, then an exec whose stage launches two kernels.
EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0, 1000),
    _x(P + "set_points", "user_annotation", 10, 290),               # 10-300
    _x(P + "set_points/(2) bin sort", "user_annotation", 20, 180),  # 20-200
    _x("cudaLaunchKernel", "cuda_runtime", 30, 5, corr=1),
    _x("sort_kernel", "kernel", 40, 60, corr=1),                    # 40-100
    _x("cudaMemcpyAsync", "cuda_runtime", 110, 5, corr=2),
    _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 112, 2, corr=2),
    _x("cudaStreamSynchronize", "cuda_runtime", 116, 4, corr=3),
    _x(P + "set_points/(3) sorted copies", "user_annotation", 200, 90),  # 200-290
    _x("cudaLaunchKernel", "cuda_runtime", 210, 5, corr=4),
    _x("index_elementwise_kernel", "kernel", 220, 70, corr=4),     # 220-290
    _x(P + "exec_type1", "user_annotation", 400, 500),              # 400-900
    _x("cudaMemcpyAsync", "cuda_runtime", 405, 5, corr=5),          # the preparation's copy
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 410, 10, corr=5),
    _x(P + "exec_type1/(1) spreading", "user_annotation", 450, 300),  # 450-750
    _x("cudaLaunchKernel", "cuda_runtime", 460, 5, corr=6),
    _x("spread_3d_kernel", "kernel", 470, 200, corr=6),            # 470-670
    _x("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=7),
    _x("fill_kernel", "kernel", 760, 40, corr=7),                   # 760-800, after the stage
    _x("cudaMemcpy", "cuda_runtime", 850, 20, corr=8),              # synchronous
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 855, 10, corr=8),
    # outside the window: ignored
    _x(P + "exec_type2", "user_annotation", 1200, 100),
    _x("cudaLaunchKernel", "cuda_runtime", 1210, 5, corr=9),
    _x("k", "kernel", 1220, 50, corr=9),
    # the device side of a record_function range is not a device operation
    _x(P + "exec_type1", "gpu_user_annotation", 470, 330),
]


def test_device_seconds_by_correlation():
    s = spans.reduce(EVENTS)
    assert s[P + "set_points/(2) bin sort"]["device_s"] == pytest.approx(62e-6)
    assert s[P + "set_points/(3) sorted copies"]["device_s"] == pytest.approx(70e-6)
    assert s[P + "set_points"]["device_s"] == pytest.approx(132e-6)
    # a kernel launched inside the stage counts there, though it ran after it
    assert s[P + "exec_type1/(1) spreading"]["device_s"] == pytest.approx(240e-6)
    assert s[P + "exec_type1"]["device_s"] == pytest.approx(260e-6)


def test_self_device_seconds_are_outside_the_children():
    s = spans.reduce(EVENTS)
    assert s[P + "set_points"]["self_device_s"] == pytest.approx(0.0)
    # the preparation's copy and the synchronous copy
    assert s[P + "exec_type1"]["self_device_s"] == pytest.approx(20e-6)
    assert s[P + "exec_type1/(1) spreading"]["self_device_s"] == pytest.approx(240e-6)


def test_blocking_calls():
    s = spans.reduce(EVENTS)
    # the pageable read and its synchronise
    assert s[P + "set_points/(2) bin sort"]["blocking"] == 2
    assert s[P + "set_points"]["blocking"] == 2
    assert s[P + "set_points/(3) sorted copies"]["blocking"] == 0
    # a pageable upload and a synchronous cudaMemcpy
    assert s[P + "exec_type1"]["blocking"] == 2
    assert s[P + "exec_type1/(1) spreading"]["blocking"] == 0


def test_idle_inside_spans():
    s = spans.reduce(EVENTS)
    # bin sort 20-200: busy 40-100 and 112-114
    assert s[P + "set_points/(2) bin sort"]["idle_s"] == pytest.approx(118e-6)
    # sorted copies 200-290: busy 220-290
    assert s[P + "set_points/(3) sorted copies"]["idle_s"] == pytest.approx(20e-6)
    # set_points 10-300: its children's idle and 10-20, 290-300
    assert s[P + "set_points"]["idle_s"] == pytest.approx(158e-6)
    assert s[P + "set_points"]["self_idle_s"] == pytest.approx(20e-6)
    # exec 400-900: busy 410-420, 470-670, 760-800, 855-865
    assert s[P + "exec_type1"]["idle_s"] == pytest.approx(240e-6)
    assert s[P + "exec_type1/(1) spreading"]["idle_s"] == pytest.approx(100e-6)


def test_span_counts_and_window():
    events = EVENTS + [_x(P + "set_points", "user_annotation", 920, 20)]
    s = spans.reduce(events)
    assert s[P + "set_points"]["count"] == 2
    assert s[P + "exec_type1"]["count"] == 1
    assert P + "exec_type2" not in s  # starts after the window


def test_nothing_to_reduce():
    assert spans.reduce([]) == {}
    assert spans.reduce([e for e in EVENTS if e["name"] != trace.WINDOW]) == {}
    assert spans.reduce([e for e in EVENTS if not e["name"].startswith(P)]) == {}


def test_summarise_names_a_gap_by_the_innermost_span():
    """The existing reduction, unchanged, names a gap inside the program
    with no torch operation running by the program's span."""
    events = EVENTS + [_x("nufftbench.exec_type1", "user_annotation", 395, 510)]
    gaps = dict(trace.summarise(events)["idle_gaps"])
    # the gap 670-760 is inside the stage, with no torch operation at its middle
    assert gaps["exec_type1 > nufft:exec_type1/(1) spreading"] > 0


def test_prefix_matches_the_program():
    from nonuniformffts_tpu_torch.utils import timer

    assert spans.SPAN_PREFIX == timer.SPAN_PREFIX
    assert not spans.SPAN_PREFIX.startswith(trace.CALL_PREFIX)


TABLE = {
    P + "set_points": {"blocking": 4.0, "idle_ms": 0.2, "device_ms": 7.5},
    P + "set_points/(2) bin sort": {"blocking": 4.0, "idle_ms": 0.1, "device_ms": 2.5},
    P + "exec_type1": {"blocking": 0.0, "idle_ms": 0.3, "device_ms": 20.0},
    P + "exec_type2": {"blocking": 1.0, "idle_ms": 0.1, "device_ms": 12.0},
}
LOAD = {"hash_s": 0.02, "compile_s": 0.0, "dlopen_s": 0.3, "builds": 0}


def test_readings():
    r = span_profile.readings(TABLE, LOAD)
    assert r == pytest.approx({"sort_ms": 2.5, "set_points_syncs": 4.0, "exec_syncs": 1.0,
                               "exec_idle_ms": 0.4, "library_load_s": 0.32})


def test_readings_without_spans():
    assert span_profile.readings({}, None) == {}
    fixed = {k: v for k, v in TABLE.items() if "set_points" not in k}
    assert set(span_profile.readings(fixed, dict.fromkeys(LOAD, 0))) == {
        "exec_syncs", "exec_idle_ms"}


def test_per_step():
    table = {P + "x": {"count": 10, "blocking": 20, "device_s": 0.01, "self_device_s": 0.0,
                       "idle_s": 0.002, "self_idle_s": 0.001}}
    assert span_profile.per_step(table, 10)[P + "x"] == pytest.approx(
        {"count": 1.0, "blocking": 2.0, "device_ms": 1.0, "self_device_ms": 0.0,
         "idle_ms": 0.2, "self_idle_ms": 0.1})


def test_library_load_reader(monkeypatch):
    from nonuniformffts_tpu_torch.ops.kernels import build

    rec = harness.Record(shapes=None)
    read = harness.metric_reader("library_load_s")
    monkeypatch.setattr(build, "LOAD", dict.fromkeys(LOAD, 0))
    assert read(rec) is None  # never loaded in this process
    monkeypatch.setattr(build, "LOAD", dict(LOAD))
    assert read(rec) == pytest.approx(0.32)
    monkeypatch.delattr(build, "LOAD")
    assert read(rec) is None  # a program that keeps no record


@pytest.mark.parametrize("name", ["c128.rho1.moving", "f64.rho0p1.fixed"])
def test_profiled_stretch_on_the_cpu(tiny, name):
    cell = tiny(name)
    line = span_profile.profile_cell(cell, 2**33 + 7, 0.2, "cpu")
    assert line["failed"] == 0 and line["steps"] >= 1
    labels = {k.removeprefix(P) for k in line["spans"]}
    stages = {"exec_type1", "exec_type1/(1) spreading", "exec_type1/(2) forward FFT",
              "exec_type1/(3) deconvolve + truncate", "exec_type2",
              "exec_type2/(1) deconvolve + pad", "exec_type2/(2) backward FFT",
              "exec_type2/(3) interpolation"}
    if cell.traffic["motion"] == "moving":
        stages |= {"set_points"} | {f"set_points/{s}" for s in (
            "(1) cell split", "(2) bin sort", "(3) sorted copies", "(4) window taps",
            "(5) transform groups")}
    assert labels == stages
    assert all(row["count"] == pytest.approx(1.0) for row in line["spans"].values())
    assert "exec_idle_ms" in line["readings"]
