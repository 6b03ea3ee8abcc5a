"""Operations and bytes of the cells' work, from shapes alone.

The count is the work the result needs, whatever implements it: each
input of an op read once and each output written once, products as
2 x M x N x K floating-point operations, no recompute.  Activations and
the products' operands are bfloat16 (2 bytes), as the ViT configurations
state; parameters, their gradients and AdamW's state are float32.  A
float32 configuration (the text encoder's) counts 4-byte activations.

An op is (name, flops, bytes).  ``least_seconds`` is the sum, op by op,
of max(flops / peak, bytes / bandwidth), the H100 SXM's published dense
rate of the configuration's compute type and HBM3 bandwidth at its 700 W
limit: bfloat16's 989 TFLOP/s, and for float32 the dense TF32 tensor
rate, 494.7 TFLOP/s, above anything a float32-faithful program reaches
(``peak_flops``).  ``model_flops`` is the products' operations alone
(attention's two included), forward and backward: the count behind
``mfu``.  Only products carry operations;
layer norms, casts and other elementwise passes carry bytes alone, and
AdamW, whose operations are no model's, is left out of ``model_flops``.

A family (families/<family>.py) gives its tower's forward ops; the ViT
families build them with ``tower_forward`` from their shapes (``d``
width, ``m`` MLP width, ``layers``, ``p`` patch, ``s`` rows an image,
``out`` the projection's width or None).  The step and the extraction
around a tower are the same for every family.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
HBM_BYTES_PER_S = 3.35e12
ACT = 2     # bfloat16
FP32 = 4
PARAM = FP32


def peak_flops(compute_dtype: str) -> float:
    """The dense tensor peak a configuration's products are held to."""
    return {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_TF32_FLOPS}[compute_dtype]


def product(name, rows, k, n, nbytes, extra_in=0):
    """A product [rows, k] @ [k, n] (+ a residual read in) of ``nbytes``
    elements: bytes of the activation in, the weight, the output, and the
    residual."""
    return (name, 2.0 * rows * k * n, nbytes * (rows * k + k * n + rows * n) + extra_in)


def _mm(name, rows, k, n, extra_in=0):
    return product(name, rows, k, n, ACT, extra_in)


def layer_forward(sh: dict, batch: int, cls_only: bool = False) -> list:
    """One pre-LN block.  ``cls_only``: the model keeps only the CLS row,
    so keys and values are computed for every row, the query, the
    attention output and the MLP for one row an image."""
    d, m, s = sh["d"], sh["m"], sh["s"]
    t = batch * s
    q_rows = batch if cls_only else t
    attn_flops = 4.0 * batch * (1 if cls_only else s) * s * d
    ops = [("attn_qkv", 2.0 * t * d * 2 * d + 2.0 * q_rows * d * d,
            ACT * (t * d + 3 * d * d + t * 2 * d + q_rows * d)),
           ("attn_core", attn_flops, ACT * (t * 2 * d + q_rows * d + q_rows * d)),
           _mm("attn_out", q_rows, d, d, extra_in=ACT * q_rows * d),
           _mm("mlp_in", q_rows, d, m),
           _mm("mlp_out", q_rows, m, d, extra_in=ACT * q_rows * d)]
    return ops


def tower_forward(sh: dict, batch: int, cls_only_last: bool = True) -> list:
    """Patch embedding from uint8, the layers, the final LN and (CLIP)
    the projection."""
    d, p, s = sh["d"], sh["p"], sh["s"]
    n = s - 1
    ops = [("patch_embed", 2.0 * batch * n * 3 * p * p * d,
            batch * n * 3 * p * p + ACT * (3 * p * p * d + batch * n * d)),
           ("embed_ln", 0.0, ACT * 2 * batch * s * d)]
    for i in range(sh["layers"]):
        last = cls_only_last and i == sh["layers"] - 1
        ops += [(f"layer{i}.{name}", f, b)
                for name, f, b in layer_forward(sh, batch, cls_only=last)]
    if sh["out"]:
        ops.append(_mm("proj", batch, d, sh["out"]))
    return ops


def backward(ops: list, input_grad: bool = True) -> list:
    """Each op's backward: twice its products (the input's and the
    weight's gradients; once without ``input_grad``) and its bytes again
    plus the output gradient's."""
    mult = 2.0 if input_grad else 1.0
    return [(f"{name}.bwd", mult * f, 2 * b) for name, f, b in ops]


def train_step(fwd: list, width: int, batch: int, text_batch: int, classes: int,
               text_width: int, n_params: int, n_tower_params: int) -> list:
    """The full-model finetune step around a tower whose forward is
    ``fwd`` and whose features are ``width`` wide: the tower forward and
    backward, the head (``img_proj_w`` where the features' width is not
    the text width), the text rows through the head, the per-step cast of
    the tower's float32 weights to bfloat16, zero_grad and AdamW over
    every trainable parameter."""
    head = []
    if width != text_width:
        head.append(("img_proj", 2.0 * batch * width * text_width,
                     PARAM * (batch * width + width * text_width + batch * text_width)))
    head += [("head_img", 2.0 * batch * text_width * classes,
              PARAM * (batch * text_width + text_width * classes + batch * classes)),
             ("head_txt", 2.0 * text_batch * text_width * classes,
              PARAM * (text_batch * text_width + text_width * classes + text_batch * classes))]
    # the tower's first op reads the pixels, which take no gradient
    ops = fwd + head + backward(fwd[:1], input_grad=False) + backward(fwd[1:] + head)
    ops.append(("weight_cast", 0.0, (PARAM + ACT) * n_tower_params))
    ops.append(("zero_grad", 0.0, PARAM * n_params))
    # AdamW: read p, g, m, v; write p, m, v
    ops.append(("adamw", 12.0 * n_params, 7 * PARAM * n_params))
    return ops


def extract(fwd: list, width: int, batch: int) -> list:
    """The serving forward of a batch (``fwd``, weights cached in
    bfloat16) and its ``width``-wide features' cast to float32 for the
    host."""
    return fwd + [("features_fp32", 0.0, (ACT + PARAM) * batch * width)]


def model_flops(ops: list) -> float:
    """The products' operations, forward and backward: every op's but the
    optimizer's (an op other than a product counts bytes alone)."""
    return sum(f for name, f, _ in ops if name != "adamw")


def least_seconds(ops: list, peak: float) -> float:
    return sum(max(f / peak, b / HBM_BYTES_PER_S) for _, f, b in ops)
