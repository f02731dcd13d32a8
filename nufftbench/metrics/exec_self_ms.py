"""exec_self_ms: the Timer's ``exec_type1`` and ``exec_type2`` sections a
step less their stages: the host's own time in the API and the stage
sequencing."""

EXECS = ("exec_type1", "exec_type2")


def read(rec):
    whole = rec.per_step_s(*EXECS)
    if whole is None:
        return None
    stages = [n for n in rec.timer_times if n.split("/")[0] in EXECS and n.count("/") == 1]
    return 1e3 * (whole - (rec.per_step_s(*stages) or 0.0))
