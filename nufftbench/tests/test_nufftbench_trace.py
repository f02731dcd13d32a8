"""The reduction of a profiler trace: busy time as a union, the window
from the harness's annotation, the breakdown by name."""

import pytest

from nufftbench import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(trace.WINDOW, "user_annotation", 1000, 1000),
    _x("nufftbench.exec_type1", "user_annotation", 1000, 400),
    _x("aten::fft_c2c", "cpu_op", 1300, 50),
    _x("nufftbench.synchronize", "user_annotation", 1400, 600),
    _x("spread_kernel", "kernel", 1100, 300),   # 1100-1400
    _x("fft_kernel", "kernel", 1350, 250),      # overlaps: 1350-1600
    _x("Memcpy DtoD", "gpu_memcpy", 1700, 100),  # 1700-1800
    _x("before_window", "kernel", 500, 300),     # outside: ignored
    _x("tail_kernel", "kernel", 1950, 200),      # clipped to 1950-2000
]


def test_busy_window_and_gaps():
    s = trace.summarise(EVENTS)
    # union 1100-1600, 1700-1800, 1950-2000 = 650 us of 1000
    assert s["busy_s"] == pytest.approx(650e-6)
    assert s["window_s"] == pytest.approx(1000e-6)
    ops = dict(s["device_ops"])
    assert ops["spread_kernel"] == pytest.approx(300e-6)
    assert ops["tail_kernel"] == pytest.approx(50e-6)
    assert "before_window" not in ops
    gaps = dict(s["idle_gaps"])
    # 1000-1100 inside exec_type1; 1600-1700 and 1800-1950 in the synchronise
    assert gaps["exec_type1"] == pytest.approx(100e-6)
    assert gaps["synchronize"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_innermost_host_op_names_a_gap():
    events = [_x(trace.WINDOW, "user_annotation", 0, 100),
              _x("nufftbench.exec_type2", "user_annotation", 0, 100),
              _x("aten::copy_", "cpu_op", 0, 100),
              _x("k", "kernel", 60, 40)]
    s = trace.summarise(events)
    assert dict(s["idle_gaps"]) == {"exec_type2 > aten::copy_": pytest.approx(60e-6)}


def test_nothing_to_read():
    assert trace.summarise([_x("k", "kernel", 0, 10)]) is None  # no window
    assert trace.summarise([_x(trace.WINDOW, "user_annotation", 0, 10)]) is None  # no device op


def test_top_entries_are_capped():
    events = [_x(trace.WINDOW, "user_annotation", 0, 10_000)]
    events += [_x(f"k{i}", "kernel", 100 * i, 10 + i) for i in range(30)]
    s = trace.summarise(events)
    assert len(s["device_ops"]) == trace.TOP and len(s["idle_gaps"]) <= trace.TOP
    assert s["device_ops"][0][0] == "k29"


def test_a_trace_file_is_read_back(tmp_path):
    import json

    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert trace.load_events(path) == EVENTS
    assert trace.summarise_file(path) == trace.summarise(EVENTS)
