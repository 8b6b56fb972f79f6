"""See the package docstring of hcmvs_tpu_torch."""
