"""step_p95_ms: the 95th percentile of every step's host-clock time in the
window (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    if not rec.step_times:
        return None
    return 1e3 * float(np.percentile(np.asarray(rec.step_times), 95))
