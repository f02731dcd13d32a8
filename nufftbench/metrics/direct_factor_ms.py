"""direct_factor_ms: the Timer's ``phase factors`` sections inside both
execs' ``(1) direct NUDFT`` a step (the chunks' phases, their cos / sin and
the tail factor's outer product).  None where the program opens no such
section."""

SECTIONS = ("exec_type1/(1) direct NUDFT/phase factors",
            "exec_type2/(1) direct NUDFT/phase factors")


def read(rec):
    s = rec.per_step_s(*SECTIONS)
    return None if s is None else 1e3 * s
