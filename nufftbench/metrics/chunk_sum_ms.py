"""chunk_sum_ms: ms a step of a points-chunked plan's sum of its chunks'
grids in type 1 (``chunked.py:exec_type1_chunked``, ``grid.add_``), over
the profiled stretch of a traced run: the in-place adds (``aten::add_``)
that run directly inside the program's ``(1) spreading`` spans, no other
operation or span between.  Their time is that of the device operations
they launch, joined by the trace's correlation ids; on a trace with no
device operation (a CPU run) the adds' own time.  None where no spreading
span holds such an add, as on a plain plan, whose spread stage is one
kernel."""

from nufftbench import spans, trace

ADD = "aten::add_"
STAGE = "(1) spreading"
HOST = ("cpu_op", "user_annotation")


def _end(e) -> float:
    return float(e["ts"]) + float(e["dur"])


def read(rec):
    xs = [e for e in rec.trace_events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs
           if e.get("name") == trace.WINDOW and e.get("cat") in trace.HOST_CATEGORIES]
    if not win or not rec.trace_steps:
        return None
    lo, hi = float(win[0]["ts"]), _end(win[0])
    host = [e for e in xs if e.get("cat") in HOST and e is not win[0]
            and lo <= float(e["ts"]) <= hi]
    sums = []
    for add in (e for e in host if e.get("cat") == "cpu_op" and e.get("name") == ADD):
        a, b = float(add["ts"]), _end(add)
        # the events that hold the add, not those it holds
        around = [e for e in host if float(e["ts"]) <= a and _end(e) >= b
                  and (float(e["ts"]) < a or _end(e) > b)]
        inner = max(around, key=lambda e: (float(e["ts"]), -float(e["dur"])), default=None)
        name = "" if inner is None else inner.get("name", "")
        label = name.removeprefix(spans.SPAN_PREFIX)
        if label != name and label.rsplit("/", 1)[-1] == STAGE:
            sums.append(add)
    if not sums:
        return None
    device = [e for e in xs if e.get("cat") in trace.DEVICE_CATEGORIES]
    if not device:
        return 1e-3 * sum(float(e["dur"]) for e in sums) / rec.trace_steps
    dev_us = {}
    for e in device:
        c = spans._correlation(e)
        if c is not None:
            dev_us[c] = dev_us.get(c, 0.0) + float(e["dur"])
    calls = [e for e in xs if e.get("cat") in spans.RUNTIME_CATEGORIES]
    total_us = sum(dev_us.get(spans._correlation(c), 0.0) for add in sums for c in calls
                   if float(add["ts"]) <= float(c["ts"]) <= _end(add))
    return 1e-3 * total_us / rec.trace_steps
