"""Representation-alignment metrics (counterpart of uml_tpu.metrics; the
part the supervised loop uses)."""
