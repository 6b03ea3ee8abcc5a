"""Weight initializers matching the distributions the reference trains from.

The port of uml_tpu/models/initializers.py.  The reference's trainable
modules are stock ``torch.nn.Linear`` layers, whose default init is
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both weights and biases.  Here the
draws come from an explicit ``torch.Generator``, on an ``nn.Linear``
weight's [out, in] layout (fan_in = shape[1]; uml_tpu's flax kernels are
[in, out]).  Matching the *distribution*, not jax.random's bits, keeps
trajectories statistically comparable; the parity tests convert
uml_tpu's initial parameters instead (models/convert.py).
"""

from __future__ import annotations

import torch


def _uniform(generator, shape, bound, dtype):
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def torch_linear_weight(generator, shape, dtype=torch.float32):
    """[out, in] weight, U(+-1/sqrt(in))."""
    return _uniform(generator, shape, shape[1] ** -0.5, dtype)


def torch_linear_bias_for(fan_in: int):
    def init(generator, shape, dtype=torch.float32):
        return _uniform(generator, shape, fan_in ** -0.5, dtype)

    return init
