"""grid_zero_ms: the Timer's ``exec_type1/(1) spreading/grid zero`` a
step, the zeroed allocation of the spread's ``(C',) + shape_over`` grid
(every group's, in a grouped call).  None where the program opens no such
section."""


def read(rec):
    s = rec.per_step_s("exec_type1/(1) spreading/grid zero")
    return None if s is None else 1e3 * s
