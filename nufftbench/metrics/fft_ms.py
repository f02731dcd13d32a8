"""fft_ms: the Timer's forward and backward FFT sections a step."""


def read(rec):
    s = rec.per_step_s("exec_type1/(2) forward FFT", "exec_type2/(2) backward FFT")
    return None if s is None else 1e3 * s
