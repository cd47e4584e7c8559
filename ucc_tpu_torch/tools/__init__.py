"""Command-line tools of ucc_tpu_torch."""
