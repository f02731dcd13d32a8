"""The benchmark of nonuniformffts_tpu_torch on one NVIDIA H100 (see README.md)."""
