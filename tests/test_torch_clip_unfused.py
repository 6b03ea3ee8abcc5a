"""The non-fused CLIP branch of the port (``attn_impl`` / ``ln_matmul_impl``)
and the text tower under autograd, against uml_tpu on the same weights (CPU).

A tiny ViT CLIP (width 128, 2 layers of 2 heads in each tower, patch 16,
resolution 64: the config of uml_tpu's multi-device dry run) is initialised
in JAX; state_dict_from_jax carries its weights into the port, whatever
the branch: the non-fused branch declares the same parameter tree.

Tolerances: fp32 features against uml_tpu's model with the same arguments
1e-4 abs (the same math in another summation order), against the port's
fused path 3e-4 (the bound of uml_tpu's dry run for fused vs reference);
bf16 per-row cosine >= 0.999; loss and gradients, fp32, 1e-4 abs and rel
against ``jax.value_and_grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.models.clip import CLIP as JaxCLIP
from uml_tpu.models.clip import ClipConfig as JaxConfig
from uml_tpu_torch.models import clip as tclip
from uml_tpu_torch.models.clip import CLIP, ClipConfig, build_clip
from uml_tpu_torch.models.convert import state_dict_from_jax
from uml_tpu_torch.models.tokenizer import tokenize

TINY = dict(embed_dim=64, image_resolution=64, vision_layers=2,
            vision_width=128, vision_patch_size=16, transformer_width=128,
            transformer_heads=2, transformer_layers=2)
PROMPTS = ["a photo of a cat.", "a bad photo of the Boeing 737-800.", "x"]
FP32_ATOL = 1e-4
FUSED_ATOL = 3e-4
GRAD_TOL = 1e-4
MIN_COSINE = 0.999
# (attn_impl, ln_matmul_impl) of the non-fused branch
UNFUSED = [("reference", "auto"), ("pallas", "auto"), ("dense_bshd", "auto"),
           ("auto", "reference"), ("reference", "reference"),
           ("reference", "pallas")]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    for var in ("UML_TEXT_TOWER", "UML_TOWER_Q8", "UML_BWD_STASH",
                "UML_MLP_STASH", "UML_MLP_BWD"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxCLIP(JaxConfig(**TINY))
    v = jax.jit(model.init)(jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32),
                            jnp.zeros((1, 77), jnp.int32))
    return jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (3, 64 * 64 * 3), dtype=np.uint8)
    return images, tokenize(PROMPTS)


def _port(variables, dtype=torch.float32, **kw):
    model = CLIP(ClipConfig(**TINY), dtype=dtype, **kw)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


def _jax_image(variables, images, dtype=jnp.float32, return_tokens=False, **kw):
    model = JaxCLIP(JaxConfig(**TINY), dtype=dtype, **kw)
    return np.asarray(jnp.asarray(model.apply(
        variables, jnp.asarray(images),
        method=lambda m, x: m.encode_image_u8(x, return_tokens=return_tokens)),
        jnp.float32))


def _jax_text(variables, tokens, **kw):
    model = JaxCLIP(JaxConfig(**TINY), dtype=jnp.float32, **kw)
    return np.asarray(model.apply(variables, jnp.asarray(tokens),
                                  method=lambda m, t: m.encode_text(t)))


def test_state_dict_carries_every_weight_into_the_non_fused_model(jax_variables):
    """convert.py needs no change: both branches declare one tree."""
    sd = state_dict_from_jax(jax_variables)
    fused = CLIP(ClipConfig(**TINY))
    unfused = CLIP(ClipConfig(**TINY), attn_impl="reference",
                   ln_matmul_impl="reference")
    assert set(fused.state_dict()) == set(unfused.state_dict()) == set(sd)
    unfused.load_state_dict(sd)   # strict: every key, no extra


@pytest.mark.parametrize("attn_impl,ln_matmul_impl", UNFUSED)
def test_image_features_match_uml_tpu_and_the_fused_path(
        jax_variables, inputs, attn_impl, ln_matmul_impl):
    images, _ = inputs
    kw = dict(attn_impl=attn_impl, ln_matmul_impl=ln_matmul_impl)
    want = _jax_image(jax_variables, images, **kw)
    with torch.no_grad():
        got = _port(jax_variables, **kw).encode_image_u8(torch.from_numpy(images))
        fused = _port(jax_variables).encode_image_u8(torch.from_numpy(images))
    assert got.shape == (3, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=FUSED_ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl,ln_matmul_impl", UNFUSED)
def test_text_features_match_uml_tpu_and_the_fused_path(
        jax_variables, inputs, attn_impl, ln_matmul_impl):
    _, tokens = inputs
    kw = dict(attn_impl=attn_impl, ln_matmul_impl=ln_matmul_impl)
    want = _jax_text(jax_variables, tokens, **kw)
    tok = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        got = _port(jax_variables, **kw).encode_text(tok)
        fused = _port(jax_variables).encode_text(tok)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=FUSED_ATOL, rtol=0)


def test_return_tokens_runs_every_layer_in_full(jax_variables, inputs):
    images, _ = inputs
    want = _jax_image(jax_variables, images, return_tokens=True,
                      attn_impl="reference")
    with torch.no_grad():
        got = _port(jax_variables, attn_impl="reference").encode_image_u8(
            torch.from_numpy(images), return_tokens=True)
    assert got.shape == (3, 17, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["reference", "pallas"])
def test_bf16_features_match_uml_tpu(jax_variables, inputs, attn_impl):
    images, _ = inputs
    want = _jax_image(jax_variables, images, dtype=jnp.bfloat16,
                      attn_impl=attn_impl)
    with torch.no_grad():
        got = _port(jax_variables, torch.bfloat16, attn_impl=attn_impl) \
            .encode_image_u8(torch.from_numpy(images)).numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= MIN_COSINE, cos.min()


@pytest.mark.parametrize("causal", [False, True])
def test_cls_only_is_row_0_of_the_full_layer(jax_variables, causal):
    block = _port(jax_variables, attn_impl="reference") \
        .visual.transformer.resblocks[0]
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 17, 128)).astype(np.float32))
    with torch.no_grad():
        full = block(x, causal=causal)
        cls = block(x, cls_only=True, causal=causal)
    assert cls.shape == (2, 1, 128)
    assert torch.equal(cls, full[:, :1])


def test_unknown_impl_values_behave_as_uml_tpu(jax_variables, inputs):
    """An unknown attn_impl takes the non-fused branch with the plain
    attention; an unknown ln_matmul_impl is not "reference", so with
    attn_impl "auto" the fused path stays, with another attn_impl the ops
    run their plain versions."""
    images, _ = inputs
    u8 = torch.from_numpy(images)
    for kw, same_as in ((dict(attn_impl="whatever"), dict(attn_impl="reference")),
                        (dict(ln_matmul_impl="whatever"), {}),
                        (dict(attn_impl="reference", ln_matmul_impl="whatever"),
                         dict(attn_impl="reference", ln_matmul_impl="reference"))):
        want = _jax_image(jax_variables, images, **kw)
        with torch.no_grad():
            got = _port(jax_variables, **kw).encode_image_u8(u8)
            twin = _port(jax_variables, **same_as).encode_image_u8(u8)
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
        assert torch.equal(got, twin)
    with pytest.raises(ValueError):
        build_clip("ViT-B/16", attn_impl="reference", quant="int4")


def _spy(monkeypatch, names):
    """Count the calls of the ops the model reaches, by their names in
    models/clip.py -> {name: calls}."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*args, _fn=getattr(tclip, name), _name=name, **kwargs):
            calls[_name] += 1
            if _name == "multi_head_attention":
                calls.setdefault("impl", set()).add(kwargs["impl"])
            return _fn(*args, **kwargs)
        monkeypatch.setattr(tclip, name, counted)
    return calls


OPS = ("ln_matmul", "add_ln_matmul", "multi_head_attention",
       "dense_attention_bshd", "attn_block", "attn_block_cls", "mlp_block",
       "text_tower", "attn_block_q8", "attn_block_q8_plain", "mlp_block_q8",
       "mlp_block_q8_plain")


@pytest.mark.parametrize("attn_impl,ln_matmul_impl,want", [
    ("auto", "auto", dict(attn_block=1, attn_block_cls=1, mlp_block=2)),
    ("fused", "pallas", dict(attn_block=1, attn_block_cls=1, mlp_block=2)),
    ("reference", "auto", dict(ln_matmul=2, add_ln_matmul=2,
                               multi_head_attention=2)),
    ("pallas", "auto", dict(ln_matmul=2, add_ln_matmul=2,
                            multi_head_attention=2)),
    ("dense_bshd", "auto", dict(ln_matmul=2, add_ln_matmul=2,
                                dense_attention_bshd=2)),
    ("auto", "reference", dict(ln_matmul=2, add_ln_matmul=2,
                               multi_head_attention=2)),
    ("fused", "reference", dict(ln_matmul=2, add_ln_matmul=2,
                                multi_head_attention=2)),
])
def test_image_routing(jax_variables, inputs, monkeypatch, attn_impl,
                       ln_matmul_impl, want):
    """Which op each (attn_impl, ln_matmul_impl) reaches, per 2-layer image
    encode (clip.py:272, :305-334)."""
    images, _ = inputs
    model = _port(jax_variables, attn_impl=attn_impl,
                  ln_matmul_impl=ln_matmul_impl)
    calls = _spy(monkeypatch, OPS)
    with torch.no_grad():
        model.encode_image_u8(torch.from_numpy(images))
    impls = calls.pop("impl", set())
    assert calls == {**dict.fromkeys(OPS, 0), **want}, calls
    if want.get("multi_head_attention"):
        assert impls == {attn_impl}   # the attention follows attn_impl


@pytest.mark.parametrize("env,attn_impl,ln_matmul_impl,want", [
    # auto: the tower only on the card; on the CPU layer by layer
    (None, "auto", "auto", dict(attn_block=2, mlp_block=2)),
    ("1", "auto", "auto", dict(text_tower=1)),
    ("0", "auto", "auto", dict(attn_block=2, mlp_block=2)),
    ("1", "fused", "pallas", dict(text_tower=1)),
    # the gate wants the fused path (clip.py:447-449)
    ("1", "reference", "auto", dict(ln_matmul=2, add_ln_matmul=2,
                                    multi_head_attention=2)),
    ("1", "auto", "reference", dict(ln_matmul=2, add_ln_matmul=2,
                                    multi_head_attention=2)),
])
def test_text_routing(jax_variables, inputs, monkeypatch, env, attn_impl,
                      ln_matmul_impl, want):
    _, tokens = inputs
    if env is not None:
        monkeypatch.setenv("UML_TEXT_TOWER", env)
    model = _port(jax_variables, attn_impl=attn_impl,
                  ln_matmul_impl=ln_matmul_impl)
    calls = _spy(monkeypatch, OPS)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(tokens.astype(np.int64)))
    calls.pop("impl", None)
    assert calls == {**dict.fromkeys(OPS, 0), **want}, calls
    np.testing.assert_allclose(got.numpy(), _jax_text(jax_variables, tokens),
                               atol=FUSED_ATOL, rtol=0)


@pytest.mark.parametrize("knobs", [dict(attn_impl="reference"),
                                   dict(ln_matmul_impl="reference")])
def test_quant_with_reference_runs_the_plain_int8_halves(
        jax_variables, inputs, monkeypatch, knobs):
    """clip.py:225-227: "reference" on either knob under a quant mode is
    the caller's request for the plain (simulated-int8) halves."""
    images, tokens = inputs
    model = _port(jax_variables, torch.bfloat16, quant="int8", **knobs)
    auto = _port(jax_variables, torch.bfloat16, quant="int8")
    monkeypatch.setenv("UML_TOWER_Q8", "1")   # the tower wants the fused path
    calls = _spy(monkeypatch, OPS)
    with torch.no_grad():
        got = model.encode_image_u8(torch.from_numpy(images))
        got_t = model.encode_text(torch.from_numpy(tokens.astype(np.int64)))
    calls.pop("impl", None)
    # image: 1 full int8 layer + the bf16 CLS layer through the branch the
    # knobs select; text: 2 causal int8 layers
    assert calls["attn_block_q8_plain"] == calls["mlp_block_q8_plain"] == 3
    assert calls["attn_block_q8"] == calls["mlp_block_q8"] == 0
    assert calls["ln_matmul"] == calls["add_ln_matmul"] == 1
    monkeypatch.delenv("UML_TOWER_Q8")
    with torch.no_grad():
        want_t = auto.encode_text(torch.from_numpy(tokens.astype(np.int64)))
    # on the CPU the int8 ops run their plain versions either way
    assert torch.equal(got_t, want_t)
    assert torch.isfinite(got).all()


def _grad_dict(model):
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


def _check_grads(got, want_sd, prefix, skip_k_bias=True):
    """Every gradient the port produced against uml_tpu's (carried through
    state_dict_from_jax, a linear map), and no gradient missing where
    uml_tpu's is nonzero."""
    checked = 0
    for key, w in want_sd.items():
        if key not in got:
            assert w.abs().max().item() == 0.0, key
            continue
        g = got[key]
        if skip_k_bias and key.endswith("attn.in_proj_bias"):
            # the k-bias third has an exactly zero gradient (the softmax
            # cancels it): both sides hold rounding noise there
            g, w = (torch.cat([t.chunk(3)[0], t.chunk(3)[2]]) for t in (g, w))
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=key)
        checked += key.startswith(prefix)
    return checked


@pytest.mark.parametrize("attn_impl,ln_matmul_impl",
                         [("reference", "auto"), ("pallas", "pallas")])
def test_image_tower_loss_and_gradients_match_jax(jax_variables, inputs,
                                                  attn_impl, ln_matmul_impl):
    """One fp32 loss-and-gradient step through the non-fused image tower,
    the configuration uml_tpu's multi-device dry run trains."""
    images, _ = inputs
    kw = dict(attn_impl=attn_impl, ln_matmul_impl=ln_matmul_impl)
    cot = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    jmodel = JaxCLIP(JaxConfig(**TINY), dtype=jnp.float32, **kw)

    def jloss(v):
        f = jmodel.apply(v, jnp.asarray(images),
                         method=lambda m, x: m.encode_image_u8(x))
        return (f * jnp.asarray(cot)).sum()

    want_loss, want = jax.value_and_grad(jloss)(jax_variables)
    model = _port(jax_variables, **kw)
    loss = (model.encode_image_u8(torch.from_numpy(images))
            * torch.tensor(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, want))
    n = _check_grads(_grad_dict(model), want_sd, "visual.")
    assert n == sum(k.startswith("visual.") for k in want_sd)


@pytest.mark.parametrize("env", ["1", "0", None])
def test_encode_text_is_differentiable(jax_variables, inputs, monkeypatch, env):
    """UML_TEXT_TOWER=1: through TextTowerFn (the backward differentiates
    text_tower_plain); "0" and, on the CPU, the default: layer by layer
    through the half-blocks' Functions.  Both against jax.grad."""
    _, tokens = inputs
    if env is not None:
        monkeypatch.setenv("UML_TEXT_TOWER", env)
    cot = np.random.default_rng(3).standard_normal((3, 64)).astype(np.float32)
    jmodel = JaxCLIP(JaxConfig(**TINY), dtype=jnp.float32)

    def jloss(v):
        f = jmodel.apply(v, jnp.asarray(tokens), method=lambda m, t: m.encode_text(t))
        return (f * jnp.asarray(cot)).sum()

    want_loss, want = jax.value_and_grad(jloss)(jax_variables)
    model = _port(jax_variables)
    applied = []
    monkeypatch.setattr(
        tclip.TextTowerFn, "apply",
        lambda *a, _fn=tclip.TextTowerFn.apply: applied.append(1) or _fn(*a))
    loss = (model.encode_text(torch.from_numpy(tokens.astype(np.int64)))
            * torch.tensor(cot)).sum()
    loss.backward()
    assert len(applied) == (1 if env == "1" else 0)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, want))
    got = _grad_dict(model)
    text_keys = [k for k in want_sd if not k.startswith("visual.")
                 and k != "logit_scale"]
    assert all(k in got for k in text_keys)
    assert _check_grads(got, want_sd, "transformer.") == sum(
        k.startswith("transformer.") for k in want_sd)


def test_non_fused_text_tower_gradient_matches_jax(jax_variables, inputs):
    _, tokens = inputs
    cot = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32)
    jmodel = JaxCLIP(JaxConfig(**TINY), dtype=jnp.float32, attn_impl="reference")
    want = jax.grad(lambda v: (jmodel.apply(
        v, jnp.asarray(tokens), method=lambda m, t: m.encode_text(t))
        * jnp.asarray(cot)).sum())(jax_variables)
    model = _port(jax_variables, attn_impl="reference")
    (model.encode_text(torch.from_numpy(tokens.astype(np.int64)))
     * torch.tensor(cot)).sum().backward()
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, want))
    assert _check_grads(_grad_dict(model), want_sd, "transformer.") == sum(
        k.startswith("transformer.") for k in want_sd)


def test_caches_follow_the_parameters_on_the_non_fused_branch(jax_variables,
                                                              inputs):
    images, _ = inputs
    model = _port(jax_variables, attn_impl="reference")
    with torch.no_grad():
        before = model.encode_image_u8(torch.from_numpy(images))
        sd = state_dict_from_jax(jax_variables)
        sd["visual.transformer.resblocks.1.mlp.c_proj.weight"] *= 2
        model.load_state_dict(sd)
        after = model.encode_image_u8(torch.from_numpy(images))
    assert not torch.allclose(before, after)
