"""interp_ms: the Timer's ``exec_type2/(3) interpolation`` a step."""


def read(rec):
    s = rec.per_step_s("exec_type2/(3) interpolation")
    return None if s is None else 1e3 * s
