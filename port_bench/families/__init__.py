"""One module per model family, found by the name a configuration gives:

* ``schema`` / ``state_dict``: the public state-dict schema the benchmark
  draws weights in;
* ``build_backbone``, ``head_extra``, ``build_head``: the program's model
  and UML head built from it, through the program's own state-dict path,
  as the finetune CLI builds them;
* ``units``: how the program's trainable leaves map onto the schema's;
* ``resolution``, ``feature_width``, ``forward_ops``: the input size, the
  features' width and the tower forward's operations and bytes
  (port_bench/flops.py);
* ``counters``: the program's launch counters of the tower's kernels;
* ``reference_features``: the plain float32 forward
  (``reference/<family>.py``).

A text-only family (``llama_encoder``) has no image tower, head or
units: ``build_text_model`` (the program's TextModel), ``vocab``,
``feature_width``, ``forward_ops(cfg, lengths)`` of one call's real
tokens, ``counters`` and ``reference_features`` (ids and mask to the
pooled features).

A new configuration of a family is a data file only; a new family is a
file here and its plain forward under ``reference/``."""
