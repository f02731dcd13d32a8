"""step_ms: the window's wall time over the steps it completed; each step
ends in a synchronise."""


def read(rec):
    if not rec.step_times:
        return None
    return 1e3 * rec.window_s / len(rec.step_times)
