"""LayerNorm -> matmul ops: the MLP half-block
x + act(rawLN(x) @ w1 + b1) @ w2 + b2 and the stand-alone
``ln_matmul`` / ``add_ln_matmul`` of the non-fused CLIP branch.

The port of uml_tpu/ops/ln_matmul.py::_mlp_block_kernel (its jnp twin is
``_raw_mlp_block_reference``) and of its training twins
``_mlp_block_kernel_stash``, ``_mlp_bwd_kernel`` and
``_mlp_bwd_dw_kernel``.  The ops take the post-fold weights (the LN
scale/bias folded into w1/b1 by fold_ln_into_matmul): on a CPU tensor
they run the plain PyTorch versions below, on a CUDA tensor they launch
``csrc/mlp_block.cu`` (the LN row pre-pass and two products on the wgmma
engine) or ``csrc/mlp_block_bwd.cu``
or raise, and count the launch.

* ``mlp_block``: the inference forward, with CLIP's quick_gelu (the
  default), DINO's exact GELU or no activation.
* ``mlp_block_stash``: the training forward -> (out, pre), pre =
  rawLN(x) @ w1 + b1 rounded to bf16; the activation is taken of the
  unrounded pre, the order of ln_matmul.py:199-204.
* ``mlp_bwd_via_stash``: the backward from the stash, plain PyTorch as
  the TPU package leaves it to XLA (``_mlp_bwd_via_stash``,
  ln_matmul.py:256-293): act and act' are evaluated at the bf16-rounded
  pre, as the reference does.
* ``mlp_bwd`` (``_mlp_bwd_kernel``, UML_MLP_BWD=kernel): from x and dy =
  g @ w2^T, rounded to bf16 outside, it recomputes pre and returns
  (dx_ln, xn, dpre, yact); ``mlp_bwd_via_kernel`` assembles the five
  grads around it as ``_mlp_bwd_via_kernel`` does (ln_matmul.py:397-414):
  dy, the residual, the dW products and the bias sums outside.
* ``mlp_bwd_dw`` (``_mlp_bwd_dw_kernel``, UML_MLP_BWD=dw): from x and g,
  dy in fp32 inside, the residual inside, and dw1, db1, dw2 as fp32 sums
  over every row inside -> (dx, dw1, db1, dw2); ``mlp_bwd_dw_via_kernel``
  adds db2 and casts the dW to the weight dtype (ln_matmul.py:536-543).
  Both take act and act' of the fp32 pre (b1 included), where the stash
  backward takes them of the bf16-rounded pre.
* ``MlpBlockFn``: the autograd Function.  Under the memory gate
  ``mlp_stash_enabled`` (the reference's ``_mlp_stash_enabled`` and
  MLP_STASH_MAX_BYTES) it stashes pre; otherwise it runs ``mlp_block``,
  and its backward is picked by UML_MLP_BWD as uml_tpu's
  ``_mlp_block_vjp_bwd`` picks it (ln_matmul.py:577-604): "dw" (3-d x)
  ``mlp_bwd_dw_via_kernel``, "kernel" ``mlp_bwd_via_kernel``, anything
  else the autograd of the plain twin, recomputed (TF32 products on the
  card, ``_vjp.py``).  Unset, it is "kernel" on the card and the plain
  twin on the CPU (``mlp_bwd_mode``).

The training forms (the stash, the backwards, ``MlpBlockFn``) take
``activation``: CLIP's quick_gelu, x * sigmoid(1.702 x) (ln_matmul.py:
678-679, the default), or DINO's exact GELU, x Phi(x) with the derivative
Phi(x) + x phi(x) (ln_matmul.py:303-307; erf on the card and in the plain
versions, where the TPU kernels fit it with a rational).  uml_tpu's
identity (None) has no stash and no user on a training path here: the
training forms refuse it.

The stand-alone ops (``csrc/ln_matmul.cu``), with uml_tpu's signatures and
``impl`` values ("auto": the plain version for a CPU tensor, the kernel for
a CUDA tensor; "pallas": the hand-written kernel; both raise on a CUDA
tensor the gate ``supports_ln_matmul`` does not take, and never run the
plain version there; anything else, e.g. "reference": the plain version):

* ``ln_matmul``: act(LN(x) @ w + b), the port of ``_ln_matmul_kernel`` and
  ``_ln_matmul_kernel_3d`` (one entry: a contiguous [B, S, K] is [B*S, K]
  here).  Where the TPU wrapper folds the LN affine into w and b on every
  call, the LN pre-pass applies it (``ln_affine_rows_plain`` is its plain
  form), then the wgmma engine runs the product; ``ln_matmul_plain``, the
  unfolded ``ln_matmul_reference``, is the op's twin.
* ``add_ln_matmul``: (t, act(LN(t) @ w + b)) with t = x + delta, the port
  of ``_add_ln_matmul_kernel``: the pre-pass (``add_ln_affine_rows_plain``)
  writes t and the affine LN of the unrounded fp32 sum, then the engine's
  product.
* activations: None, "quick_gelu" (CLIP), "gelu_exact" (DINO; erf on the
  card, where the TPU kernel fits a sigmoid of a quintic because Mosaic has
  no erf).  The VMEM gate of uml_tpu's ``supports_ln_matmul`` (k*m*2 <=
  8 MB) is not carried: the engine streams the weight in tiles.
* gradients: ``LnMatmulFn`` / ``AddLnMatmulFn`` run the kernel forward and
  differentiate the plain twin, recomputed, as uml_tpu's custom_vjp do
  (ln_matmul.py:824-833, :962-971).
"""

from __future__ import annotations

import os

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops._vjp import plain_vjp


def raw_layer_norm_rstd(xf: torch.Tensor, eps: float):
    """(xn, rstd): LayerNorm without affine over the last axis, on fp32
    input, with the statistics that define the reference's outputs:
    var = max(E[x^2] - E[x]^2, 0) (flax use_fast_variance)."""
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def raw_layer_norm(xf: torch.Tensor, eps: float) -> torch.Tensor:
    return raw_layer_norm_rstd(xf, eps)[0]


def ln_rows_plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the LN row pre-pass of the CUDA kernels
    (csrc/ln_gemm.cuh::ln_rows_kernel): the raw LayerNorm of each row with
    fp32 statistics, rounded once to x's dtype — the operand the wgmma
    engine's QKV and MLP dW products read."""
    return raw_layer_norm(x.float(), eps).to(x.dtype)


def ln_affine_rows_plain(x: torch.Tensor, scale, bias,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the affine LN pre-pass (ln_gemm.cuh::ln_rows_kernel
    <PRO_LN_AFFINE>, rows 14, 15 and 17): the raw LayerNorm of each row
    with fp32 statistics, times the LN scale plus the LN bias in fp32,
    rounded once to x's dtype — the operand the wgmma engine reads."""
    xn = raw_layer_norm(x.float(), eps) * scale.float() + bias.float()
    return xn.to(x.dtype)


def add_ln_affine_rows_plain(x: torch.Tensor, delta: torch.Tensor, scale,
                             bias, eps: float = 1e-5):
    """Plain version of the add LN pre-pass (ln_rows_kernel
    <PRO_ADD_LN_AFFINE>, row 16) -> (t, xn): t32 = x + delta in fp32, t =
    t32 rounded to x's dtype, and xn the affine LN of the unrounded t32,
    rounded once."""
    t32 = x.float() + delta.float()
    xn = raw_layer_norm(t32, eps) * scale.float() + bias.float()
    return t32.to(x.dtype), xn.to(x.dtype)


def raw_layer_norm_bwd(dxn, xn, rstd):
    """The backward of raw_layer_norm in fp32:
    rstd * (dxn - mean(dxn) - xn * mean(dxn * xn))."""
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    return rstd * (dxn - m1 - xn * m2)


def quick_gelu_f32(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-1.702 * x)))


def gelu_exact_f32(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU (ln_matmul.py:682-684)."""
    return x * 0.5 * (1.0 + torch.erf(x * 2.0 ** -0.5))


ACTIVATIONS = {None: lambda x: x, "quick_gelu": quick_gelu_f32,
               "gelu_exact": gelu_exact_f32}
# the C entries' activation codes (csrc/ln_gemm.cuh ACT_*)
_ACT_CODE = {None: 0, "quick_gelu": 1, "gelu_exact": 2}


def _act_code(activation) -> int:
    if activation not in _ACT_CODE:
        raise ValueError(f"activation={activation!r}: have {list(_ACT_CODE)}")
    return _ACT_CODE[activation]


def _mlp_plain(x, w1, b1, w2, b2, eps, activation):
    """-> (out, pre): bf16 (or fp32) operands, fp32 products and
    statistics, one rounding to the weight dtype before each matmul; the
    activation of the unrounded fp32 pre."""
    xf = x.float()
    xn = raw_layer_norm(xf, eps).to(w1.dtype)
    pre = xn.float() @ w1.float() + b1.float()
    y = ACTIVATIONS[activation](pre).to(w2.dtype)
    out = (xf + y.float() @ w2.float() + b2.float()).to(x.dtype)
    return out, pre


def mlp_block_plain(x, w1, b1, w2, b2, *, eps: float = 1e-5,
                    activation: str | None = "quick_gelu"):
    """Plain PyTorch version of ``mlp_block``."""
    return _mlp_plain(x, w1, b1, w2, b2, eps, activation)[0]


def _check_mlp(x, w1, b1, w2, b2):
    """What the MLP kernels take -> (rows, K, M, dtype, device)."""
    k = x.shape[-1]
    m = w1.shape[-1]
    _build.check_dims(K=k, M=m)
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, x.shape, dev)
    _build.check_tensor("w1", w1, bf16, (k, m), dev)
    _build.check_tensor("b1", b1, torch.float32, (m,), dev)
    _build.check_tensor("w2", w2, bf16, (m, k), dev)
    _build.check_tensor("b2", b2, torch.float32, (k,), dev)
    return x.numel() // k, k, m, bf16, dev


def mlp_block(x, w1, b1, w2, b2, *, eps: float = 1e-5,
              activation: str | None = "quick_gelu"):
    """x [..., K] bf16; w1 [K, M] bf16 (ln_2-folded); b1 [M] fp32;
    w2 [M, K] bf16; b2 [K] fp32 -> [..., K]; ``activation``: None,
    'quick_gelu' (CLIP) or 'gelu_exact' (DINO)."""
    act = _act_code(activation)
    if x.device.type == "cpu":
        return mlp_block_plain(x, w1, b1, w2, b2, eps=eps, activation=activation)
    rows, k, m, bf16, dev = _check_mlp(x, w1, b1, w2, b2)
    with torch.cuda.device(dev):
        xn = torch.empty_like(x)
        hidden = torch.empty((rows, m), dtype=bf16, device=dev)
        out = torch.empty_like(x)
        _build.launch("uml_mlp_block", x.data_ptr(), w1.data_ptr(),
                      b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      xn.data_ptr(), hidden.data_ptr(), out.data_ptr(), rows,
                      k, m, act, eps, torch.cuda.current_stream(dev).cuda_stream)
    mlp_block.launches += 1
    return out


mlp_block.launches = 0


def ln_mlp_block(x, scale, bias, w1, b1, w2, b2, *, eps: float = 1e-5,
                 activation: str | None = None):
    """x + act(LN(x) @ w1 + b1) @ w2 + b2 with the LN affine params folded
    into w1/b1 first — the signature of uml_tpu's ln_mlp_block, whose
    default activation is None, the identity."""
    from uml_tpu_torch.ops.fused_attention import fold_ln_into_matmul

    w1_eff, b1_eff = fold_ln_into_matmul(scale, bias, w1, b1)
    return mlp_block(x, w1_eff, b1_eff, w2, b2.float(), eps=eps,
                     activation=activation)


MLP_STASH_MAX_BYTES = 256 * 2**20  # per-layer pre-stash cap (see the gate)


def mlp_stash_enabled(bsz: int, s: int, m: int, itemsize: int) -> bool:
    """Stash the MLP pre-activation for the backward (UML_MLP_STASH=auto):
    ON while one layer's stash [B, S, M] stays under MLP_STASH_MAX_BYTES
    (bs128 ViT-B/16: 155 MB per layer); UML_MLP_STASH=1/0 forces it.
    The same gate as uml_tpu's _mlp_stash_enabled (ln_matmul.py:168-183)."""
    env = os.environ.get("UML_MLP_STASH", "auto")
    if env in ("0", "1"):
        return env == "1"
    return bsz * s * m * itemsize <= MLP_STASH_MAX_BYTES


TRAIN_ACTIVATIONS = ("quick_gelu", "gelu_exact")


def _train_act_code(activation) -> int:
    """The C entries' code of a training activation; None (the identity)
    and unknown names raise."""
    if activation not in TRAIN_ACTIVATIONS:
        raise ValueError(f"activation={activation!r}: the training forms take "
                         f"{list(TRAIN_ACTIVATIONS)}")
    return _ACT_CODE[activation]


def mlp_block_stash_plain(x, w1, b1, w2, b2, *, eps: float = 1e-5,
                          activation: str = "quick_gelu"):
    """Plain PyTorch version of the stash forward -> (out, pre)."""
    _train_act_code(activation)
    out, pre = _mlp_plain(x, w1, b1, w2, b2, eps, activation)
    return out, pre.to(x.dtype)


def mlp_block_stash(x, w1, b1, w2, b2, *, eps: float = 1e-5,
                    activation: str = "quick_gelu"):
    """The training forward of the MLP half-block: x [B, S, K] ->
    (out [B, S, K], pre [B, S, M])."""
    act = _train_act_code(activation)
    if x.device.type == "cpu":
        return mlp_block_stash_plain(x, w1, b1, w2, b2, eps=eps,
                                     activation=activation)
    rows, k, m, bf16, dev = _check_mlp(x, w1, b1, w2, b2)
    with torch.cuda.device(dev):
        pre = torch.empty((*x.shape[:-1], m), dtype=bf16, device=dev)
        xn = torch.empty_like(x)
        hidden = torch.empty((rows, m), dtype=bf16, device=dev)
        out = torch.empty_like(x)
        _build.launch("uml_mlp_block_stash", x.data_ptr(), w1.data_ptr(),
                      b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      pre.data_ptr(), xn.data_ptr(), hidden.data_ptr(),
                      out.data_ptr(), rows, k, m, act, eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    mlp_block_stash.launches += 1
    return out, pre


mlp_block_stash.launches = 0


def act_and_grad(pre32: torch.Tensor, activation: str = "quick_gelu"):
    """(act(pre), d act(pre) / d pre) in fp32 (ln_matmul.py:296-307
    computes the same two values): quick_gelu from one sigmoid s, s (1 +
    1.702 x (1 - s)); exact GELU from Phi(x) = (1 + erf(x / sqrt 2)) / 2,
    x Phi(x) and Phi(x) + x phi(x), phi(x) = exp(-x^2 / 2) / sqrt(2 pi)."""
    _train_act_code(activation)
    if activation == "gelu_exact":
        phi_big = 0.5 * (1.0 + torch.erf(pre32 * 2.0 ** -0.5))
        phi_small = torch.exp(-0.5 * pre32 * pre32) * 0.3989422804014327
        return pre32 * phi_big, phi_big + pre32 * phi_small
    s = torch.sigmoid(1.702 * pre32)
    grad = pre32 * (1.0 - s)
    grad.mul_(1.702).add_(1.0).mul_(s)
    return pre32 * s, grad


def mlp_bwd_via_stash(x, g, pre, w1, b1, w2, b2, *, eps: float = 1e-5,
                      activation: str = "quick_gelu"):
    """All five grads of the MLP half-block from the stashed pre ->
    (dx, dw1, db1, dw2, db2); the products take operands in the weight
    dtype and accumulate in fp32 (ln_matmul.py:256-293)."""
    xn32, rstd = raw_layer_norm_rstd(x.float(), eps)
    xnb = xn32.to(w1.dtype)

    act, dact = act_and_grad(pre.float(), activation)
    yact = act.to(w2.dtype)
    dpre = torch.matmul(g.to(w2.dtype), w2.t()).float().mul_(dact)   # [..., M]
    dpreb = dpre.to(w1.dtype)
    dxn = torch.matmul(dpreb, w1.t()).float()                       # [..., K]
    dx = (raw_layer_norm_bwd(dxn, xn32, rstd) + g.float()).to(x.dtype)

    k, m = w1.shape
    dw1 = torch.matmul(xnb.reshape(-1, k).t(), dpreb.reshape(-1, m))
    db1 = dpre.reshape(-1, m).sum(0)
    dw2 = torch.matmul(yact.reshape(-1, m).t(), g.reshape(-1, k).to(w2.dtype))
    db2 = g.reshape(-1, k).sum(0, dtype=torch.float32)
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _mlp_rows(x, w1, b1, eps, activation):
    """The recompute shared by the two backward kernels' plain versions:
    -> (xn32, rstd, xnb, act, dact) with pre = xnb @ w1 + b1 in fp32."""
    xn32, rstd = raw_layer_norm_rstd(x.float(), eps)
    xnb = xn32.to(w1.dtype)
    act, dact = act_and_grad(xnb.float() @ w1.float() + b1.float(), activation)
    return xn32, rstd, xnb, act, dact


def mlp_bwd_plain(x, dy, b1, w1, *, eps: float = 1e-5,
                  activation: str = "quick_gelu"):
    """Plain PyTorch version of _mlp_bwd_kernel: x [..., K], dy [..., M]
    -> (dx_ln, xn, dpre, yact) in x's dtype; dx_ln has no residual."""
    xn32, rstd, xnb, act, dact = _mlp_rows(x, w1, b1, eps, activation)
    dpre = (dy.float() * dact).to(w1.dtype)
    dxn = dpre.float() @ w1.float().t()
    dx_ln = raw_layer_norm_bwd(dxn, xn32, rstd)
    return (dx_ln.to(x.dtype), xnb.to(x.dtype), dpre.to(x.dtype),
            act.to(x.dtype))


def mlp_bwd_dw_plain(x, g, b1, w1, w2, *, eps: float = 1e-5,
                     activation: str = "quick_gelu"):
    """Plain PyTorch version of _mlp_bwd_dw_kernel: x, g [B, S, K] ->
    (dx [B, S, K] with the residual, dw1 [K, M], db1 [M], dw2 [M, K]),
    the three weight gradients fp32 sums over every row."""
    k, m = w1.shape
    xn32, rstd, xnb, act, dact = _mlp_rows(x, w1, b1, eps, activation)
    dpre = (g.float() @ w2.float().t()) * dact
    dpreb = dpre.to(w1.dtype)
    dxn = dpreb.float() @ w1.float().t()
    dx = (raw_layer_norm_bwd(dxn, xn32, rstd) + g.float()).to(x.dtype)
    dw1 = xnb.reshape(-1, k).float().t() @ dpreb.reshape(-1, m).float()
    db1 = dpre.reshape(-1, m).sum(0)
    dw2 = act.to(w1.dtype).reshape(-1, m).float().t() @ g.reshape(-1, k).float()
    return dx, dw1, db1, dw2


def mlp_bwd(x, dy, b1, w1, *, eps: float = 1e-5, activation: str = "quick_gelu"):
    """The MLP half's backward kernel with dy = g @ w2^T given: x [..., K]
    bf16; dy [..., M] bf16; b1 [M] fp32; w1 [K, M] bf16 -> (dx_ln, xn
    [..., K], dpre, yact [..., M])."""
    act = _train_act_code(activation)
    if x.device.type == "cpu":
        return mlp_bwd_plain(x, dy, b1, w1, eps=eps, activation=activation)
    k, m = w1.shape
    _build.check_dims(K=k, M=m)
    bf16, dev = torch.bfloat16, x.device
    rows = x.numel() // k
    _build.check_tensor("x", x, bf16, x.shape, dev)
    _build.check_tensor("dy", dy, bf16, (*x.shape[:-1], m), dev)
    _build.check_tensor("b1", b1, torch.float32, (m,), dev)
    _build.check_tensor("w1", w1, bf16, (k, m), dev)
    with torch.cuda.device(dev):
        dpre = torch.empty_like(dy)
        yact = torch.empty_like(dy)
        dxn = torch.empty((rows, k), dtype=torch.float32, device=dev)
        dx_ln = torch.empty_like(x)
        xn = torch.empty_like(x)
        _build.launch("uml_mlp_bwd", x.data_ptr(), dy.data_ptr(), b1.data_ptr(),
                      w1.data_ptr(), dpre.data_ptr(), yact.data_ptr(),
                      dxn.data_ptr(), dx_ln.data_ptr(), xn.data_ptr(), rows, k,
                      m, act, eps, torch.cuda.current_stream(dev).cuda_stream)
    mlp_bwd.launches += 1
    return dx_ln, xn, dpre, yact


mlp_bwd.launches = 0


def mlp_bwd_dw(x, g, b1, w1, w2, *, eps: float = 1e-5,
               activation: str = "quick_gelu"):
    """The MLP half's backward kernel with the weight gradients inside:
    x, g [B, S, K] bf16; b1 [M] fp32; w1 [K, M], w2 [M, K] bf16 -> (dx
    [B, S, K] bf16, dw1 [K, M], db1 [M], dw2 [M, K] fp32)."""
    act = _train_act_code(activation)
    if x.device.type == "cpu":
        return mlp_bwd_dw_plain(x, g, b1, w1, w2, eps=eps, activation=activation)
    k, m = w1.shape
    _build.check_dims(K=k, M=m)
    f32, bf16, dev = torch.float32, torch.bfloat16, x.device
    rows = x.numel() // k
    _build.check_tensor("x", x, bf16, x.shape, dev)
    _build.check_tensor("g", g, bf16, x.shape, dev)
    _build.check_tensor("b1", b1, f32, (m,), dev)
    _build.check_tensor("w1", w1, bf16, (k, m), dev)
    _build.check_tensor("w2", w2, bf16, (m, k), dev)
    with torch.cuda.device(dev):
        dy = torch.empty((rows, m), dtype=f32, device=dev)
        dpre = torch.empty((rows, m), dtype=bf16, device=dev)
        yact = torch.empty((rows, m), dtype=bf16, device=dev)
        dxn = torch.empty((rows, k), dtype=f32, device=dev)
        # the column sums of dpre per 128-row tile of the wgmma engine
        db1_part = torch.empty((-(-rows // 128), m), dtype=f32, device=dev)
        dx = torch.empty_like(x)
        xn = torch.empty_like(x)
        dw1 = torch.empty((k, m), dtype=f32, device=dev)
        db1 = torch.empty((m,), dtype=f32, device=dev)
        dw2 = torch.empty((m, k), dtype=f32, device=dev)
        _build.launch("uml_mlp_bwd_dw", x.data_ptr(), g.data_ptr(), b1.data_ptr(),
                      w1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
                      dpre.data_ptr(), yact.data_ptr(), dxn.data_ptr(),
                      db1_part.data_ptr(), dx.data_ptr(), xn.data_ptr(),
                      dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), rows, k, m,
                      act, eps, torch.cuda.current_stream(dev).cuda_stream)
    mlp_bwd_dw.launches += 1
    return dx, dw1, db1, dw2


mlp_bwd_dw.launches = 0


def mlp_bwd_via_kernel(x, g, w1, b1, w2, b2, *, eps: float = 1e-5,
                       activation: str = "quick_gelu"):
    """All five grads around mlp_bwd, as _mlp_bwd_via_kernel assembles
    them: dy = g @ w2^T rounded to x's dtype, the residual added in fp32
    and rounded once, the dW products over (batch, seq) with fp32
    accumulation cast to the weight dtype -> (dx, dw1, db1, dw2, db2)."""
    k, m = w1.shape
    dy = torch.matmul(g, w2.t()).to(x.dtype)
    dx_ln, xn, dpre, yact = mlp_bwd(x, dy, b1, w1, eps=eps, activation=activation)
    dx = (dx_ln.float() + g.float()).to(x.dtype)
    g2, dpre2 = g.reshape(-1, k), dpre.reshape(-1, m)
    return (dx, torch.matmul(xn.reshape(-1, k).t(), dpre2).to(w1.dtype),
            dpre2.sum(0, dtype=torch.float32).to(b1.dtype),
            torch.matmul(yact.reshape(-1, m).t(), g2).to(w2.dtype),
            g2.sum(0, dtype=torch.float32).to(b2.dtype))


def mlp_bwd_dw_via_kernel(x, g, w1, b1, w2, b2, *, eps: float = 1e-5,
                          activation: str = "quick_gelu"):
    """All five grads around mlp_bwd_dw (_mlp_bwd_dw_via_kernel): only
    db2 outside; the fp32 dW cast to the weight dtype."""
    dx, dw1, db1, dw2 = mlp_bwd_dw(x, g, b1, w1, w2, eps=eps, activation=activation)
    db2 = g.reshape(-1, g.shape[-1]).sum(0, dtype=torch.float32)
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def mlp_bwd_mode(x) -> str | None:
    """The backward of MlpBlockFn with the stash off: UML_MLP_BWD as set
    ("dw", "kernel"; anything else is the plain VJP); unset, row 19
    ("kernel") for a tensor on the card, where the plain VJP's products
    would run 2x slower (fault F1 of ROADMAP.md), and the plain VJP on the
    CPU, as uml_tpu's default."""
    mode = os.environ.get("UML_MLP_BWD")
    if mode is None and x.is_cuda:
        return "kernel"
    return mode


class MlpBlockFn(torch.autograd.Function):
    """mlp_block with a gradient, for ``activation`` "quick_gelu" (CLIP,
    the default) or "gelu_exact" (DINO): the stash forward and backward
    under the memory gate, else the inference forward and the backward
    UML_MLP_BWD picks, each with that activation.  None (uml_tpu's
    identity default of ``ln_mlp_block``) raises: no model trains an MLP
    half without an activation."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, eps, activation="quick_gelu"):
        _train_act_code(activation)
        ctx.cfg = (eps, activation)
        if mlp_stash_enabled(x.shape[0], x.shape[1], w1.shape[1],
                             x.element_size()):
            out, pre = mlp_block_stash(x, w1, b1, w2, b2, eps=eps,
                                       activation=activation)
            ctx.save_for_backward(x, w1, b1, w2, b2, pre)
        else:
            out = mlp_block(x, w1, b1, w2, b2, eps=eps, activation=activation)
            ctx.save_for_backward(x, w1, b1, w2, b2)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        eps, activation = ctx.cfg
        kw = dict(eps=eps, activation=activation)
        if len(ctx.saved_tensors) == 6:
            x, w1, b1, w2, b2, pre = ctx.saved_tensors
            return (*mlp_bwd_via_stash(x, g, pre, w1, b1, w2, b2, **kw),
                    None, None)
        x, w1, b1, w2, b2 = ctx.saved_tensors
        mode = mlp_bwd_mode(x)
        if mode == "dw" and x.dim() == 3:
            return (*mlp_bwd_dw_via_kernel(x, g, w1, b1, w2, b2, **kw),
                    None, None)
        if mode == "kernel":
            return (*mlp_bwd_via_kernel(x, g, w1, b1, w2, b2, **kw), None, None)
        return (*plain_vjp(lambda *a: mlp_block_plain(*a, **kw),
                           ctx.saved_tensors, (g,), ctx.needs_input_grad[:5]),
                None, None)


def supports_ln_matmul(k: int, m: int, dtype=torch.bfloat16) -> bool:
    """What the pre-pass and the wgmma engine take: bf16, K and M
    multiples of 64."""
    return dtype == torch.bfloat16 and k % 64 == 0 and m % 64 == 0


def ln_matmul_plain(x, scale, bias, w, b, *, eps: float = 1e-5,
                    activation: str | None = None):
    """Plain PyTorch twin of ln_matmul_reference: fp32-statistics LN with
    its affine, rounded to the weight dtype, then act(xn @ w + b)."""
    xn = raw_layer_norm(x.float(), eps) * scale.float() + bias.float()
    out = xn.to(w.dtype).float() @ w.float() + b.float()
    return ACTIVATIONS[activation](out).to(x.dtype)


def _ln_matmul_fwd(x, scale, bias, w, b, eps, activation):
    """The plain twin for a CPU tensor, the kernel for a CUDA tensor (x
    [..., K] bf16, w [K, M] bf16; scale, bias, b go in as fp32): the affine
    LN pre-pass into an xn scratch [rows, K], then the product on the
    wgmma engine with the bias and the activation in its epilogue."""
    if x.device.type == "cpu":
        return ln_matmul_plain(x, scale, bias, w, b, eps=eps,
                               activation=activation)
    k, m = w.shape
    _build.check_dims(K=k, M=m)
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    scale, bias, b = scale.float(), bias.float(), b.float()
    _build.check_tensor("x", x, bf16, (*x.shape[:-1], k), dev)
    _build.check_tensor("scale", scale, f32, (k,), dev)
    _build.check_tensor("bias", bias, f32, (k,), dev)
    _build.check_tensor("w", w, bf16, (k, m), dev)
    _build.check_tensor("b", b, f32, (m,), dev)
    rows = x.numel() // k
    with torch.cuda.device(dev):
        xn = torch.empty((rows, k), dtype=bf16, device=dev)
        out = torch.empty((*x.shape[:-1], m), dtype=bf16, device=dev)
        _build.launch("uml_ln_matmul", x.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), w.data_ptr(), b.data_ptr(),
                      xn.data_ptr(), out.data_ptr(), rows, k, m,
                      _act_code(activation), eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    ln_matmul.launches += 1
    return out


class LnMatmulFn(torch.autograd.Function):
    """ln_matmul with a gradient: the kernel forward, the backward through
    ln_matmul_plain."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, b, eps, activation):
        ctx.cfg = (eps, activation)
        ctx.save_for_backward(x, scale, bias, w, b)
        return _ln_matmul_fwd(x, scale, bias, w, b, eps, activation)

    @staticmethod
    def backward(ctx, g):
        eps, activation = ctx.cfg
        return (*plain_vjp(
            lambda *a: ln_matmul_plain(*a, eps=eps, activation=activation),
            ctx.saved_tensors, (g,), ctx.needs_input_grad[:5]), None, None)


def ln_matmul(x, scale, bias, w, b, *, eps: float = 1e-5,
              activation: str | None = None, impl: str = "auto"):
    """act(LayerNorm(x) @ w + b) over the last axis of x.

    x: [..., K]; scale/bias: [K]; w: [K, M]; b: [M].  ``activation``:
    None | 'quick_gelu' | 'gelu_exact'.  The kernel takes every rank: the
    leading axes are its rows."""
    if _build.wants_kernel(impl, x):
        return LnMatmulFn.apply(x, scale, bias, w, b, eps, activation)
    return ln_matmul_plain(x, scale, bias, w, b, eps=eps, activation=activation)


ln_matmul.launches = 0


def add_ln_matmul_plain(x, delta, scale, bias, w, b, *, eps: float = 1e-5,
                        activation: str | None = None):
    """Plain PyTorch twin of add_ln_matmul_reference -> (t, out): t =
    x + delta rounded to x's dtype, the LN statistics and the normalized
    row taken of the unrounded fp32 sum."""
    t32 = x.float() + delta.float()
    xn = raw_layer_norm(t32, eps) * scale.float() + bias.float()
    out = xn.to(w.dtype).float() @ w.float() + b.float()
    return t32.to(x.dtype), ACTIVATIONS[activation](out).to(x.dtype)


def _add_ln_matmul_fwd(x, delta, scale, bias, w, b, eps, activation):
    """The plain twin for a CPU tensor, the kernel for a CUDA tensor (x,
    delta [..., K] bf16, w [K, M] bf16; scale, bias, b go in as fp32): the
    add LN pre-pass writes t and an xn scratch [rows, K], then the product
    on the wgmma engine."""
    if x.device.type == "cpu":
        return add_ln_matmul_plain(x, delta, scale, bias, w, b, eps=eps,
                                   activation=activation)
    k, m = w.shape
    _build.check_dims(K=k, M=m)
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    scale, bias, b = scale.float(), bias.float(), b.float()
    _build.check_tensor("x", x, bf16, (*x.shape[:-1], k), dev)
    _build.check_tensor("delta", delta, bf16, x.shape, dev)
    _build.check_tensor("scale", scale, f32, (k,), dev)
    _build.check_tensor("bias", bias, f32, (k,), dev)
    _build.check_tensor("w", w, bf16, (k, m), dev)
    _build.check_tensor("b", b, f32, (m,), dev)
    rows = x.numel() // k
    with torch.cuda.device(dev):
        xn = torch.empty((rows, k), dtype=bf16, device=dev)
        t = torch.empty_like(x)
        out = torch.empty((*x.shape[:-1], m), dtype=bf16, device=dev)
        _build.launch("uml_add_ln_matmul", x.data_ptr(), delta.data_ptr(),
                      scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
                      b.data_ptr(), xn.data_ptr(), t.data_ptr(), out.data_ptr(),
                      rows, k, m, _act_code(activation), eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    add_ln_matmul.launches += 1
    return t, out


class AddLnMatmulFn(torch.autograd.Function):
    """add_ln_matmul with a gradient: the kernel forward, the backward
    through add_ln_matmul_plain against both outputs' cotangents."""

    @staticmethod
    def forward(ctx, x, delta, scale, bias, w, b, eps, activation):
        ctx.cfg = (eps, activation)
        ctx.save_for_backward(x, delta, scale, bias, w, b)
        return _add_ln_matmul_fwd(x, delta, scale, bias, w, b, eps, activation)

    @staticmethod
    def backward(ctx, gt, gout):
        eps, activation = ctx.cfg
        return (*plain_vjp(
            lambda *a: add_ln_matmul_plain(*a, eps=eps, activation=activation),
            ctx.saved_tensors, (gt, gout), ctx.needs_input_grad[:6]), None, None)


def add_ln_matmul(x, delta, scale, bias, w, b, *, eps: float = 1e-5,
                  gelu: bool = False, activation: str | None = None,
                  impl: str = "auto"):
    """(x + delta, act(LN(x + delta) @ w + b)) over the last axis: the
    second half of a pre-LN residual block up to the activation, in one
    launch.  ``gelu=True`` is shorthand for 'quick_gelu'.  The kernel takes
    every rank: the leading axes are its rows."""
    if gelu and activation is None:
        activation = "quick_gelu"
    if _build.wants_kernel(impl, x):
        return AddLnMatmulFn.apply(x, delta, scale, bias, w, b, eps, activation)
    return add_ln_matmul_plain(x, delta, scale, bias, w, b, eps=eps,
                               activation=activation)


add_ln_matmul.launches = 0
