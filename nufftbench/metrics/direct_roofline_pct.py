"""direct_roofline_pct: the exact sums' least time from the cell's shapes
(nufftbench/roofline_direct.py), a type for each exec whose ``(1) direct
NUDFT`` stage ran, over those stages' time a step (``direct_ms``), in %."""

from nufftbench import roofline, roofline_direct

STAGE = "{}/(1) direct NUDFT"


def read(rec):
    ran = [STAGE.format(e) for e in ("exec_type1", "exec_type2")
           if STAGE.format(e) in rec.timer_times]
    s = rec.per_step_s(*ran)
    if not s:
        return None
    bound = roofline.bound_s(roofline_direct.sums_work(rec.shapes))[0]
    return 100.0 * len(ran) * bound / s
