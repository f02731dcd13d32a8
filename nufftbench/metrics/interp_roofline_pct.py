"""interp_roofline_pct: the interpolation's least time from the cell's
shapes (nufftbench/roofline.py) over the Timer's interpolation section a
step, in %."""

from nufftbench import roofline


def read(rec):
    s = rec.per_step_s("exec_type2/(3) interpolation")
    if not s:
        return None
    return 100.0 * roofline.bound_s(roofline.interp_work(rec.shapes))[0] / s
