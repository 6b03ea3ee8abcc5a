"""The rank-2H form of the CLS backward (row 8) against the dense forms.

``attn_block_cls_bwd_factored_plain`` (the math of csrc/cls_bwd.cuh: dxn
as [S, 2H] x [2H, K] per image from dS, p and the per-head vectors u, w,
plus z = dq0 Wq^T in row 0) against uml_tpu's ``_block_bwd_cls_call`` in
interpret mode (the Pallas kernel, its cotangent zero in rows 1-7 of the
[B, 8, K] tile) and against ``attn_block_cls_bwd_plain`` (the dense
dqkv . W_eff^T), on the same numpy inputs: K = 128, 2 and 4 heads of 64,
S in {9, 17, 65, 197}.

Bounds.  bf16: dqkv within bf16 rounding of the dense plain version (its
q, k and v parts are the same values rounded once: 2^-8 of the largest
entry), dx and xn within 2^-6 of the largest entry (the dense form rounds
dk and dv to bf16 before its dxn product, the factorized one does not),
the Pallas kernel held as tests/test_torch_train_ops.py holds it (1e-2 of
the largest entry: the two packages round p, dO and dS at other points;
dqkv at S >= 129 keys 2^-6, that file's LONG_S_DQKV_BF16_REL, since the
two roundings drift apart with the keys: the dense plain version lands
1.2% away at S = 197 with 4 heads, as the factorized one does).
float64: every rounding is a no-op, and the factorized dx and dqkv equal
the gradient of a float64 forward (torch.autograd) to 1e-9 of the
largest entry, which pins the algebra itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import fused_attention as jfa
from uml_tpu_torch.ops import fused_attention as tfa

K, B = 128, 2
DQKV_REL = 2.0 ** -8
DX_REL = 2.0 ** -6
PALLAS_REL = 1e-2
LONG_S, LONG_S_DQKV_REL = 129, 2.0 ** -6
F64_REL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _arrays(seed, s, heads):
    rng = np.random.default_rng(seed)
    hd = heads * 64

    def rnd(*shape, std=1.0):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return dict(x=rnd(B, s, K), g=rnd(B, 1, K), w_eff=rnd(K, 3 * hd, std=K ** -0.5),
                b_eff=rnd(3 * hd, std=0.1), wo=rnd(hd, K, std=hd ** -0.5),
                bo=rnd(K, std=0.1))


def _torch(a, dtype):
    return {n: torch.tensor(v).to(torch.float32 if n in ("b_eff", "bo") else dtype)
            for n, v in a.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _np(t):
    return t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32), np.float64)


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("s", [9, 17, 65, 197])
def test_factored_cls_backward_matches_the_dense_plain_version(s, heads):
    t = _torch(_arrays(10 * s + heads, s, heads), torch.bfloat16)
    _, qkv, _ = tfa.attn_block_stash_plain(t["x"], t["w_eff"], t["b_eff"], t["wo"],
                                           t["bo"], heads=heads, q_rows=1)
    args = (t["x"], t["g"], qkv, t["w_eff"], t["wo"])
    dx, dqkv, xn = tfa.attn_block_cls_bwd_factored_plain(*args, heads=heads)
    want = tfa.attn_block_cls_bwd_plain(*args, heads=heads)
    assert dqkv.dtype == dx.dtype == xn.dtype == torch.bfloat16
    assert _rel(_np(dqkv), _np(want[1])) <= DQKV_REL
    assert _rel(_np(dx), _np(want[0])) <= DX_REL
    assert torch.equal(xn, want[2])


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("s", [9, 17, 65, 197])
def test_factored_cls_backward_matches_pallas(s, heads):
    a = _arrays(20 * s + heads, s, heads)
    t = _torch(a, torch.bfloat16)
    j = {n: jnp.asarray(v, jnp.float32 if n in ("b_eff", "bo") else jnp.bfloat16)
         for n, v in a.items()}
    _, qkv, _ = tfa.attn_block_stash_plain(t["x"], t["w_eff"], t["b_eff"], t["wo"],
                                           t["bo"], heads=heads, q_rows=1)
    got = tfa.attn_block_cls_bwd_factored_plain(t["x"], t["g"], qkv, t["w_eff"],
                                                t["wo"], heads=heads)
    g8 = jnp.zeros((B, jfa.CLS_ROWS, K), j["g"].dtype).at[:, :1].set(j["g"])
    want = jfa._block_bwd_cls_call(j["x"], g8, j["w_eff"], j["b_eff"], j["wo"], 1e-5,
                                   heads, 64, True)
    for name, a_, w_ in zip(("dx", "dqkv", "xn"), got, want):
        bound = LONG_S_DQKV_REL if name == "dqkv" and s >= LONG_S else PALLAS_REL
        assert _rel(_np(a_), _np(w_)) <= bound, name


def _forward64(x, w_eff, b_eff, wo, bo, heads):
    """The CLS block in float64, written out: out [B, 1, K] and qkv."""
    xn = tfa.raw_layer_norm(x, 1e-5)
    qkv = xn @ w_eff + b_eff
    q, k, v = tfa._qkv_heads(qkv, heads)
    p = torch.softmax((q[:, :, :1] @ k.transpose(-1, -2)) / 8, -1)
    attn = (p @ v).transpose(1, 2).reshape(x.shape[0], 1, -1)
    return x[:, :1] + attn @ wo + bo, qkv


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("s", [9, 65])
def test_factored_cls_backward_is_the_float64_gradient(s, heads):
    t = _torch(_arrays(30 * s + heads, s, heads), torch.float64)
    t["b_eff"], t["bo"] = t["b_eff"].double(), t["bo"].double()
    x = t["x"].clone().requires_grad_(True)
    out, qkv = _forward64(x, t["w_eff"], t["b_eff"], t["wo"], t["bo"], heads)
    qkv.retain_grad()
    (out * t["g"]).sum().backward()
    dx, dqkv, xn = tfa.attn_block_cls_bwd_factored_plain(
        t["x"], t["g"], qkv.detach(), t["w_eff"], t["wo"], heads=heads)
    assert dx.dtype == torch.float64
    assert _rel(_np(dx), _np(x.grad)) <= F64_REL
    assert _rel(_np(dqkv), _np(qkv.grad)) <= F64_REL
    assert _rel(_np(xn), _np(tfa.raw_layer_norm(t["x"], 1e-5))) <= F64_REL
