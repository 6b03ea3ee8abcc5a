"""Flags, YAML sweeps and device choice (counterpart of uml_tpu.core)."""
