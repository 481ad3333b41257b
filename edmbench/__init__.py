"""The benchmark of ``edm_tpu_torch``: see ``README.md``."""
