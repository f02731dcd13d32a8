"""set_points_ms: the program's Timer section ``set_points`` a step (fold,
cell split, bin sort), synchronised."""


def read(rec):
    s = rec.per_step_s("set_points")
    return None if s is None else 1e3 * s
