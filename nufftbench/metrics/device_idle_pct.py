"""device_idle_pct: the share of the profiled stretch in which no device
operation ran (nufftbench/trace.py), in %."""


def read(rec):
    if rec.device is None or not rec.device["window_s"]:
        return None
    return 100.0 * (1.0 - rec.device["busy_s"] / rec.device["window_s"])
