"""The benchmark of monolith_tpu_torch on the card: see run.py."""
