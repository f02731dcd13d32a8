"""value_gather_ms: the Timer's ``exec_type1/(1) spreading/value gather`` a
step, the 2D and 3D spread wrapper's gather of the values into the sorted
point order (``vp[:, sort_perm]``) before its kernel.  None where the
program opens no such section (a 1D plan, whose kernel gathers them itself,
or a program without the section)."""


def read(rec):
    s = rec.per_step_s("exec_type1/(1) spreading/value gather")
    return None if s is None else 1e3 * s
