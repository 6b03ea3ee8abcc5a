"""The plain reference of the benchmark's comparison.

Plain PyTorch in float32 with TF32 off, written from the published model
descriptions and the public state-dict schemas.  It imports nothing of
the measured program and nothing of the JAX package: the benchmark hands
it the same state dict, images and text rows it hands the program, and it
works out again what the program derives from them (the folded LayerNorm
weights, the zero-shot head, the learning rate of each step).
"""
