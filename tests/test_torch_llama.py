"""The port's LlamaEncoder (uml_tpu_torch/models/llama.py) against
uml_tpu's and HF's on the CPU.

uml_tpu's flax variables (tests/test_llama.py's TINY: hidden 64, 4 heads
over 2 kv heads, 2 layers; a padded row) are carried into the port by
``convert.llama_state_dict_from_jax``.  fp32: the hidden states within
2e-5 of uml_tpu's; int8_w: the port's ``quantize_llama_params`` gives
uml_tpu's int8 weights and scales bit for bit, and the outputs agree
within 2e-5.  ``port_hf_llama`` against HF's eager LlamaModel and
MistralModel (grouped-query) at 2e-4 on the valid positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_llama import TINY as JAX_TINY
from tests.test_llama import _tokens
from uml_tpu.models import llama as jllama
from uml_tpu_torch.models import llama as tllama
from uml_tpu_torch.models.convert import llama_state_dict_from_jax

TINY = tllama.LlamaConfig(**vars(JAX_TINY))
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_params(seed=0, ids=None, mask=None):
    model = jllama.LlamaEncoder(JAX_TINY)
    v = jax.jit(model.init)(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(mask))
    return jax.tree.map(np.asarray, v)


def _run_port(model, ids, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()


def test_llama_encoder_matches_uml_tpu():
    ids, mask = _tokens(np.random.default_rng(0))
    params = _jax_params(0, ids, mask)
    want = np.asarray(jllama.LlamaEncoder(JAX_TINY).apply(
        params, jnp.asarray(ids), jnp.asarray(mask)))
    port = tllama.build_llama(TINY, llama_state_dict_from_jax(params))
    got = _run_port(port, ids, mask)
    assert got.shape == (3, 11, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_int8w_weights_bit_for_bit_and_outputs_match():
    ids, mask = _tokens(np.random.default_rng(1))
    params = _jax_params(1, ids, mask)
    jq = jllama.quantize_llama_params(params)
    want_sd = llama_state_dict_from_jax(jq)
    got_sd = tllama.quantize_llama_params(llama_state_dict_from_jax(params))
    assert set(got_sd) == set(want_sd)
    q8 = [k for k in got_sd if k.endswith("kernel_q8")]
    assert len(q8) == 2 * 7
    for key, want in want_sd.items():
        assert got_sd[key].dtype == want.dtype, key
        assert torch.equal(got_sd[key], want), key
    want = np.asarray(jllama.LlamaEncoder(JAX_TINY, quant="int8_w").apply(
        jq, jnp.asarray(ids), jnp.asarray(mask)))
    port = tllama.build_llama(TINY, got_sd, quant="int8_w")
    assert port.layers[0].self_attn["q_proj"].kernel_q8.shape == (64, 64)
    got = _run_port(port, ids, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    # the int8 projections hold a quarter of the fp32 projections' bytes
    # (plus one fp32 scale per output column)
    fp = sum(v.numel() * v.element_size() for k, v in llama_state_dict_from_jax(
        params).items() if k.endswith("proj.weight"))
    qb = sum(v.numel() * v.element_size() for k, v in got_sd.items()
             if k.endswith(("kernel_q8", "proj.scale")))
    assert qb < 0.27 * fp


@pytest.mark.parametrize("family", ["llama", "mistral"])
def test_port_hf_matches_hf_eager(family):
    """HF's eager LlamaModel / MistralModel (4 heads over 2 kv heads) and
    the port fed by ``port_hf_llama``: the hidden states at the valid
    positions (HF computes its own values at the pads, which no pooling
    reads)."""
    import transformers

    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=112,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=64, attn_implementation="eager")
    if family == "llama":
        hf_cfg, cls = transformers.LlamaConfig(**kw), transformers.LlamaModel
    else:
        hf_cfg, cls = (transformers.MistralConfig(rms_norm_eps=1e-5, **kw),
                       transformers.MistralModel)
    torch.manual_seed(0)
    hf = cls(hf_cfg).eval()
    cfg = tllama.LlamaConfig.from_hf(hf_cfg)
    assert cfg.num_key_value_heads == 2
    port = tllama.build_llama(cfg, tllama.port_hf_llama(hf.state_dict(), cfg))
    ids, mask = _tokens(np.random.default_rng(0))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
    got = _run_port(port, ids, mask)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-4, rtol=2e-4)


def test_padding_invariance_and_seeded_init():
    """A padded token never reaches a valid position; ``init_random`` on a
    model made on the meta device is seeded and fills every tensor."""
    with torch.device("meta"):
        model = tllama.LlamaEncoder(TINY)
    model.to_empty(device="cpu")
    model.init_random(torch.Generator().manual_seed(0))
    again = tllama.LlamaEncoder(TINY).init_random(torch.Generator().manual_seed(0))
    sd, sd2 = model.state_dict(), again.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert all(torch.isfinite(v).all() for v in sd.values())
    ids, mask = _tokens(np.random.default_rng(2))
    out = _run_port(model, ids, mask)
    ids2 = ids.copy()
    ids2[1, 7:] = 5
    out2 = _run_port(model, ids2, mask)
    np.testing.assert_allclose(out[1, :7], out2[1, :7], atol=1e-5)
    q8 = tllama.LlamaEncoder(TINY, quant="int8_w").init_random(
        torch.Generator().manual_seed(0))
    kq = q8.layers[0].mlp["down_proj"].kernel_q8
    assert kq.dtype == torch.int8 and kq.shape == (112, 64)
    assert np.isfinite(_run_port(q8, ids, mask)).all()
