"""library_load_s: seconds of the kernel library's load in the run's
process: hashing its sources, compiling them (0 where the built library
matched) and ``ctypes.CDLL``, from the program's own record of it
(``nonuniformffts_tpu_torch/ops/kernels/build.py:LOAD``).  None where the
program keeps no such record or never loaded the library."""


def read(rec):
    from nonuniformffts_tpu_torch.ops.kernels import build

    load = getattr(build, "LOAD", None)
    if not load or not load.get("hash_s"):
        return None
    return load["hash_s"] + load["compile_s"] + load["dlopen_s"]
