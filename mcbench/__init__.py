"""The benchmark of ``probabilit_tpu_torch`` on one H100 (see README.md)."""
