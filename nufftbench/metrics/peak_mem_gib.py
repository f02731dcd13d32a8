"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, reset
at its start, in GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
