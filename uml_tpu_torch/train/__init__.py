"""Optimizers, schedules and the supervised UML training loop
(counterpart of uml_tpu.train; the self-supervised and Gaussian loops
come later)."""
