"""The benchmark of salmon_tpu_torch (see run.py)."""
