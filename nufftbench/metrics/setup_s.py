"""setup_s: seconds from the process's start to the first timed step:
imports, the CUDA context, loading (or the first time building) the
kernels, the inputs made on the card, the plan, a fixed mix's set_points,
and the warm-up steps."""


def read(rec):
    return rec.setup_s
