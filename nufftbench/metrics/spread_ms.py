"""spread_ms: the Timer's ``exec_type1/(1) spreading`` a step."""


def read(rec):
    s = rec.per_step_s("exec_type1/(1) spreading")
    return None if s is None else 1e3 * s
