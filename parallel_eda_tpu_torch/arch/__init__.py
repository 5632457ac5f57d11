"""Port package (see parallel_eda_tpu_torch/__init__.py)."""
