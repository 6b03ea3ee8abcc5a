"""Ops of the port: each TPU kernel of uml_tpu.ops on the CLIP serving
path as a hand-written CUDA kernel for Hopper (``csrc/``), behind a
wrapper that keeps a launch count, beside its plain PyTorch version.

Nothing here builds or loads CUDA code at import; ``_build`` compiles the
kernels at the first launch on a CUDA tensor.
"""
