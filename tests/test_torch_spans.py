"""The port's sections as spans of a ``torch.profiler`` trace
(``utils/timer.py:section`` / ``traced``), on the CPU: the spans carry the
labels a ``Timer`` records, one spreading and one interpolation span a group
of transforms, nothing is made or timed with neither a profiler nor a
timer, and the outputs do not change.  Also the kernel library's load
record (``ops/kernels/build.py:LOAD``) with the compiler and the loader
replaced."""

import collections
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

import nonuniformffts_tpu_torch as tnufft
from nonuniformffts_tpu_torch import chunked
from nonuniformffts_tpu_torch.ops.kernels import build
from nonuniformffts_tpu_torch.plan import transform_groups
from nonuniformffts_tpu_torch.utils import timer as timer_mod
from torch_port_utils import random_complex, random_points

torch.set_num_threads(1)

PREFIX = timer_mod.SPAN_PREFIX
NP = 120
SHAPE = (16, 12)
#: name -> PlanNUFFT keywords
PATHS = {
    "blocked": dict(spread_method="blocked"),
    "reference": dict(spread_method="reference"),
    "reference_sorted": dict(spread_method="reference", sort_points=True),
    "direct": dict(spread_method="direct"),
}


def _callbacks(np_):
    w = torch.linspace(0.5, 1.5, np_, dtype=torch.float64)
    return tnufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple(x * w[n] for x in vs),
        uniform=lambda ws, idx: tuple(x * (1.0 + idx[0]) for x in ws),
    )


def _inputs(dtype, ntransforms=1, seed=3):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, len(SHAPE), NP, dtype)
    lead = () if ntransforms == 1 else (ntransforms,)
    if np.dtype(dtype).kind == "c":
        v = random_complex(rng, dtype, lead + (NP,))
    else:
        v = rng.standard_normal(lead + (NP,)).astype(dtype)
    plan = tnufft.PlanNUFFT(dtype, SHAPE, m=4, sigma=2.0, device="cpu")
    u = random_complex(rng, np.result_type(dtype, np.complex64), lead + plan.spectral_shape)
    return pts, v, u


def _plan(dtype, path, timer=None, ntransforms=1):
    return tnufft.PlanNUFFT(dtype, SHAPE, m=4, sigma=2.0, device="cpu", timer=timer,
                            ntransforms=ntransforms, **PATHS[path])


def _calls(plan, pts, v, u, callbacks=None):
    plan = tnufft.set_points(plan, pts)
    return (tnufft.exec_type1(plan, v, callbacks=callbacks),
            tnufft.exec_type2(plan, u, callbacks=callbacks))


def _profiled(fn):
    """``fn()`` under the CPU profiler; its result and the program's spans
    as (label, start, end), in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith(PREFIX)),
                   key=lambda s: s[1])
    return out, spans


@pytest.mark.parametrize("with_callbacks", [False, True], ids=["plain", "callbacks"])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dtype", [np.complex128, np.float32])
def test_spans_carry_the_timer_labels(dtype, path, with_callbacks):
    """A plain plan's spans under the profiler are the sections a timer
    records for the same calls, label by label and count by count."""
    pts, v, u = _inputs(dtype)
    cb = _callbacks(NP) if with_callbacks else None
    _, spans = _profiled(lambda: _calls(_plan(dtype, path), pts, v, u, cb))
    t = tnufft.Timer()
    _calls(_plan(dtype, path, timer=t), pts, v, u, cb)
    assert collections.Counter(label for label, _, _ in spans) == collections.Counter(t.counts)
    labels = {label for label, _, _ in spans}
    assert {"set_points", "exec_type1", "exec_type2"} <= labels
    assert ("set_points/(2) sort" in labels) == (path == "reference_sorted")
    # each span lies inside its parent's
    for label, a, b in spans:
        if "/" in label:
            parent = label.rsplit("/", 1)[0]
            assert any(p == parent and pa <= a and b <= pb for p, pa, pb in spans), label


def test_spans_with_a_timer_attached():
    """Profiler and timer together: the same labels in both."""
    pts, v, u = _inputs(np.complex128)
    t = tnufft.Timer()
    _, spans = _profiled(lambda: _calls(_plan(np.complex128, "blocked", timer=t), pts, v, u))
    assert collections.Counter(label for label, _, _ in spans) == collections.Counter(t.counts)


@pytest.mark.parametrize("chunk", [1, 2, 3, 5])
@pytest.mark.parametrize("path", ["blocked", "reference"])
def test_one_stage_span_a_group_of_transforms(path, chunk):
    """A grouped exec opens one ``(1) spreading`` and one ``(3)
    interpolation`` span a slice of ``transform_groups``: their count inside
    one exec span is the call's group count."""
    C = 5
    pts, v, u = _inputs(np.complex128, ntransforms=C)
    groups = len(transform_groups(C, chunk))

    def run(timer=None):
        plan = tnufft.set_points(_plan(np.complex128, path, timer, ntransforms=C), pts)
        plan = dataclasses.replace(plan, transform_chunk=chunk)
        return tnufft.exec_type1(plan, v), tnufft.exec_type2(plan, u)

    _, spans = _profiled(run)
    for top, stage in (("exec_type1", "(1) spreading"), ("exec_type2", "(3) interpolation")):
        (_, a, b), = [s for s in spans if s[0] == top]
        inside = [s for s in spans if s[0] == f"{top}/{stage}" and a <= s[1] and s[2] <= b]
        assert len(inside) == groups
    t = tnufft.Timer()
    run(t)
    assert t.counts["exec_type1/(1) spreading"] == groups
    assert t.counts["exec_type2/(3) interpolation"] == groups


def test_chunked_plan_spans():
    """A points-chunked plan's calls carry each chunk's ``set_points`` and
    the stages of its groups' passes."""
    pts, v, u = _inputs(np.complex128)
    cplan = tnufft.ChunkedPlanNUFFT(np.complex128, SHAPE, nchunks=3, m=4, sigma=2.0,
                                    spread_method="blocked", device="cpu")

    def run():
        cp = chunked.set_points_chunked(cplan, pts)
        return chunked.exec_type1_chunked(cp, v), chunked.exec_type2_chunked(cp, u)

    _, spans = _profiled(run)
    counts = collections.Counter(label for label, _, _ in spans)
    assert counts["set_points"] == 3 and counts["set_points/(2) bin sort"] == 3
    assert counts["(1) spreading"] == counts["(3) interpolation"] == 1


class _Counting:
    """Counts the calls of ``fn``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("path", ["blocked", "reference", "direct"])
def test_nothing_without_profiler_or_timer(monkeypatch, path):
    """With neither a profiler nor a timer the program enters no
    ``record_function`` and reads no clock of the timer module; with
    either, it does (so the counters see the calls)."""
    spans = _Counting(torch.profiler.record_function)
    clock = _Counting(time.perf_counter)
    monkeypatch.setattr(torch.profiler, "record_function", spans)
    monkeypatch.setattr(timer_mod, "time", types.SimpleNamespace(perf_counter=clock))
    pts, v, u = _inputs(np.complex128)
    _calls(_plan(np.complex128, path), pts, v, u, _callbacks(NP))
    assert spans.calls == 0 and clock.calls == 0
    _calls(_plan(np.complex128, path, timer=tnufft.Timer()), pts, v, u)
    assert spans.calls == 0 and clock.calls > 0
    _profiled(lambda: _calls(_plan(np.complex128, path), pts, v, u))
    assert spans.calls > 0


def test_section_stack_unwinds_on_error():
    """A call that raises inside its span leaves no label open: the next
    call's spans are not nested under it."""
    plan = _plan(np.complex128, "blocked")

    def fail():
        with pytest.raises(ValueError, match="points not set"):
            tnufft.exec_type1(plan, np.zeros(NP, np.complex128))
        return list(timer_mod._labels.stack)

    open_after, spans = _profiled(fail)
    assert open_after == [] and [label for label, _, _ in spans] == ["exec_type1"]
    pts, v, u = _inputs(np.complex128)
    _, spans = _profiled(lambda: _calls(plan, pts, v, u))
    assert {label.split("/")[0] for label, _, _ in spans} == {
        "set_points", "exec_type1", "exec_type2"}


def test_sections_nest_per_thread():
    """The labels open on one thread do not prefix another thread's."""
    seen = {}
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(timeout=30)
        t = tnufft.Timer()
        with timer_mod.section(t, "b"), timer_mod.section(t, "c"):
            seen["other"] = list(timer_mod._labels.stack)
        seen["timer"] = set(t.counts)
        done.set()

    worker = threading.Thread(target=other)
    worker.start()
    with timer_mod.section(tnufft.Timer(), "a"):
        opened.set()
        assert done.wait(timeout=30)
        seen["main"] = list(timer_mod._labels.stack)
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert seen == {"other": ["b", "c"], "timer": {"b", "b/c"}, "main": ["a"]}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_outputs_equal_with_profiler_on(dtype, path):
    pts, v, u = _inputs(dtype)
    cb = _callbacks(NP)
    u0, v0 = _calls(_plan(dtype, path), pts, v, u, cb)
    (u1, v1), spans = _profiled(lambda: _calls(_plan(dtype, path), pts, v, u, cb))
    assert spans
    assert torch.equal(u0, u1) and torch.equal(v0, v1)


def test_prefix_is_not_the_harness_prefix():
    assert PREFIX == "nufft:" and not PREFIX.startswith("nufftbench.")


# ---------------------------------------------------------------------------
# The kernel library's load record
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """``build`` on a fresh record and build directory, with nvcc and
    ``ctypes.CDLL`` replaced: ``_compile`` writes an empty library."""
    compiles = _Counting(lambda lib_path, *a, **kw: (time.sleep(0.01), lib_path.write_bytes(b"")))
    loads = _Counting(lambda path: (time.sleep(0.002), types.SimpleNamespace())[1])
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "LOCK_PATH", tmp_path / "build.lock")
    monkeypatch.setattr(build, "_compile", compiles)
    monkeypatch.setattr(build.ctypes, "CDLL", loads)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "LOAD", dict.fromkeys(build.LOAD, 0))
    return types.SimpleNamespace(compiles=compiles, loads=loads)


def test_load_record_first_build_then_stamp(monkeypatch, fake_build):
    lib = build.load()
    assert build.load() is lib and fake_build.loads.calls == 1
    rec = dict(build.LOAD)
    assert set(rec) == {"hash_s", "compile_s", "dlopen_s", "builds"}
    assert rec["builds"] == 1 and fake_build.compiles.calls == 1
    assert rec["hash_s"] > 0 and rec["compile_s"] >= 0.01 and rec["dlopen_s"] >= 0.002
    # A second process's load: the stamp matches, nothing is compiled.
    monkeypatch.setattr(build, "_lib", None)
    build.load()
    assert build.LOAD["builds"] == 1 and build.LOAD["compile_s"] == rec["compile_s"]
    assert build.LOAD["hash_s"] > rec["hash_s"] and build.LOAD["dlopen_s"] > rec["dlopen_s"]
    # Changed sources: built again.
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "source_hash", lambda: "changed")
    build.load()
    assert build.LOAD["builds"] == 2 and build.LOAD["compile_s"] > rec["compile_s"]


def test_load_record_with_build_replaced(monkeypatch, fake_build, tmp_path):
    """``load`` times its ``ctypes.CDLL`` whatever ``build`` does."""
    monkeypatch.setattr(build, "build", lambda: tmp_path / "lib.so")
    build.load()
    assert build.LOAD["dlopen_s"] >= 0.002 and fake_build.loads.calls == 1
    assert build.LOAD["builds"] == 0 and build.LOAD["hash_s"] == 0
