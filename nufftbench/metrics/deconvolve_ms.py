"""deconvolve_ms: the Timer's deconvolution sections a step, type 1's
truncation and type 2's padding."""


def read(rec):
    s = rec.per_step_s("exec_type1/(3) deconvolve + truncate", "exec_type2/(1) deconvolve + pad")
    return None if s is None else 1e3 * s
