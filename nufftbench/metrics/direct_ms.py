"""direct_ms: the Timer's ``(1) direct NUDFT`` stages of both execs a step
(``ops/direct.py``: each chunk's phase factors and product).  None where no
direct stage ran."""

STAGES = ("exec_type1/(1) direct NUDFT", "exec_type2/(1) direct NUDFT")


def read(rec):
    s = rec.per_step_s(*STAGES)
    return None if s is None else 1e3 * s
