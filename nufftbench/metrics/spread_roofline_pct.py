"""spread_roofline_pct: the spread's least time from the cell's shapes
(nufftbench/roofline.py) over the Timer's spreading section a step, in %."""

from nufftbench import roofline


def read(rec):
    s = rec.per_step_s("exec_type1/(1) spreading")
    if not s:
        return None
    return 100.0 * roofline.bound_s(roofline.spread_work(rec.shapes))[0] / s
