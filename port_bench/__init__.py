"""The benchmark of uml_tpu_torch on one NVIDIA H100 (see README.md)."""
