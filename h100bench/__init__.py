"""The H100 benchmark of permon_tpu_torch (see run.py)."""
