"""The benchmark of egorear_tpu_torch (see README.md)."""
