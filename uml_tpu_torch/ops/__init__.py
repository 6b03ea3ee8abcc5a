"""Ops of the port: each TPU kernel of uml_tpu.ops on the CLIP serving
path as a hand-written CUDA kernel for Hopper (``csrc/``), behind a
wrapper that keeps a launch count, beside its plain PyTorch version.

Nothing here builds or loads CUDA code at import; ``_build`` compiles the
kernels at the first launch on a CUDA tensor.

The package exports what ``uml_tpu.ops`` exports (``mha_reference`` under
the port's name ``mha_plain``) and ``ln_qkv_attention``.  As there,
``layer_norm`` here is the function; import the module's other names from
``uml_tpu_torch.ops.layer_norm``.  ``ln_matmul`` stays the module (its ops
are ``ln_matmul.ln_matmul`` and ``ln_matmul.add_ln_matmul``).
"""

from uml_tpu_torch.ops.attention import (dense_attention_bshd, flash_attention,
                                         mha_plain, multi_head_attention)
from uml_tpu_torch.ops.fused_attention import ln_qkv_attention
from uml_tpu_torch.ops.layer_norm import layer_norm
from uml_tpu_torch.ops.quant import (ln_attn_block_q8, ln_mlp_block_q8,
                                     quantize_weight)

__all__ = [
    "multi_head_attention",
    "mha_plain",
    "flash_attention",
    "dense_attention_bshd",
    "layer_norm",
    "ln_qkv_attention",
    "ln_attn_block_q8",
    "ln_mlp_block_q8",
    "quantize_weight",
]
