"""The strided entry of the streaming attention kernel on the CPU.

``_flash_attention_strided`` takes q, k, v as [B, H, S, D] views with any
batch, head and row strides and writes into an output view: here the
views of a packed qkv [B, S, 3, H, D] (the fused blocks' layout) and of an
attention buffer [B, S, H, D].  On the CPU it runs ``attention_plain``,
as ``flash_attention`` does; on the card the same kernel reads the views
in place (tests/test_torch_cuda.py holds it bit for bit to the contiguous
call there).

Against ``flash_attention`` on the unpacked contiguous tensors and against
uml_tpu's Pallas ``flash_attention`` in interpret mode on the same numpy
values: fp32 within 1e-5 abs (the same math in another summation order),
bf16 within 2^-6 of the largest output (an intermediate may round to the
neighbouring bf16 value; the TPU kernel keeps P in fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import attention as jat
from uml_tpu_torch.ops import attention as tat

HEADS = 2
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _packed(seed, s, d, tdtype):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((2, s, 3, HEADS, d)).astype(np.float32)
    t = torch.tensor(qkv).to(tdtype)
    # the values both sides see: the numpy array after the cast
    return t, t.float().numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 63, 65, 197])
def test_strided_entry_on_packed_qkv_matches(s, causal, d, dtype):
    jdt, tdt = DTYPES[dtype]
    packed, values = _packed(s * 7 + d, s, d, tdt)
    q, k, v = (packed[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    attn = torch.zeros(2, s, HEADS, d, dtype=tdt)
    got = tat._flash_attention_strided(q, k, v, causal=causal,
                                       out=attn.transpose(1, 2))
    assert got.data_ptr() == attn.data_ptr() and got.shape == (2, HEADS, s, d)
    want = tat.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)
    pallas = jat.flash_attention(*(jnp.asarray(values[:, :, i].transpose(0, 2, 1, 3),
                                               jdt) for i in range(3)),
                                 causal=causal)
    pallas = np.asarray(jnp.asarray(pallas, jnp.float32)).transpose(0, 2, 1, 3)
    got_np = attn.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got_np, want.transpose(1, 2).numpy(), atol=1e-5)
        np.testing.assert_allclose(got_np, pallas, atol=1e-5)
    else:
        bound = 2.0 ** -6 * np.abs(pallas).max()
        assert np.abs(got_np - want.transpose(1, 2).float().numpy()).max() <= bound
        assert np.abs(got_np - pallas).max() <= bound


def test_strided_entry_makes_a_contiguous_output_when_none_is_given():
    packed, _ = _packed(3, 9, 64, torch.float32)
    q, k, v = (packed[:, :, i].transpose(1, 2) for i in range(3))
    got = tat._flash_attention_strided(q, k, v)
    assert got.is_contiguous() and got.shape == (2, HEADS, 9, 64)
    torch.testing.assert_close(got, tat.attention_plain(q, k, v), rtol=0, atol=0)


def test_strided_entry_counts_no_launch_on_the_cpu():
    packed, _ = _packed(4, 5, 64, torch.bfloat16)
    before = tat.flash_attention.launches
    tat._flash_attention_strided(*(packed[:, :, i].transpose(1, 2)
                                   for i in range(3)))
    assert tat.flash_attention.launches == before


@pytest.mark.parametrize("view,ok", [
    ("packed", True), ("contiguous", True), ("last_axis_strided", False),
    ("row_stride_68", False)])
def test_strided_views_the_kernel_takes(view, ok):
    """What the kernel's tensor maps take (checked before a launch on the
    card): the last axis contiguous, the other strides multiples of 8
    elements (16 bytes)."""
    base = torch.zeros(2, 16, 3, HEADS, 64, dtype=torch.bfloat16)
    t = {"packed": base[:, :, 0].transpose(1, 2),
         "contiguous": torch.zeros(2, HEADS, 16, 64, dtype=torch.bfloat16),
         "last_axis_strided": base[..., ::2][:, :, 0].transpose(1, 2),
         "row_stride_68": torch.zeros(2, HEADS, 16, 68,
                                      dtype=torch.bfloat16)[..., :64]}[view]
    assert tat._strided_ok(t) is ok
