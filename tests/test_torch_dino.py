"""The port's DINO / DINOv2 encoder against uml_tpu's and HF's on the CPU.

Tiny configs (2 layers, width 128, 2 heads of 64) at patch 14 and 8; the
weights and inputs are drawn from a numpy seed and handed to both
packages (uml_tpu's flax tree through ``dino_state_dict_from_jax``).
LayerScale, the LN scales and biases, the class token and the position
embeddings are all drawn away from their inits, so every fold is seen.

Tolerances:
* fp32, the port against uml_tpu's DinoViT (which on the CPU runs its jnp
  references, the LN unfolded; the port folds it into the weights): max
  abs error 1e-4, the bound uml_tpu's HF parity test states;
* bf16: max abs error 2^-6 * max |reference|, two bf16 ulps of the
  largest output (the repo's bf16 bound, tests/test_torch_ops.py);
* int8 (bf16 compute): per-row cosine of the features at least 0.999, the
  bound of the features CLI's card-vs-CPU check;
* the port against HF Dinov2Model / ViTModel built from a config made in
  code: 1e-4 (HF's LayerNorm takes the variance in two passes, the port
  E[x^2] - E[x]^2 as flax does; at eps 1e-6 that moves the outputs by a
  few 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.models import dino as jdino
from uml_tpu.ops import quant as jq
from uml_tpu.ops.ln_matmul import _ACTIVATIONS, _KERNEL_ACTIVATIONS
from uml_tpu_torch.models import dino as tdino
from uml_tpu_torch.models.convert import dino_state_dict_from_jax
from uml_tpu_torch.ops import gemm as tgemm
from uml_tpu_torch.ops import quant as tq

WIDTH, LAYERS, HEADS = 128, 2, 2
FP32_ATOL = 1e-4
BF16_REL = 2.0 ** -6
MIN_COSINE = 0.999
FLIP_SHARE = 1e-3
MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _config(patch, layerscale=True, image_size=None):
    size = image_size or {14: 56, 8: 64}[patch]
    return jdino.DinoConfig(WIDTH, LAYERS, HEADS, patch, image_size=size,
                            layerscale=layerscale, pretrain_image_size=size)


def _variables(cfg, seed):
    """uml_tpu's flax tree for ``cfg`` with every leaf drawn from a numpy
    seed: kernels lecun-scaled, LN scales near 1, LayerScale in [0.2, 1.2],
    biases, class token and position embeddings nonzero."""
    model = jdino.DinoViT(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros(
        (1, cfg.image_size, cfg.image_size, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = s.shape
        if name.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape) * fan_in ** -0.5
        elif "layerscale" in name:
            a = rng.uniform(0.2, 1.2, shape)
        elif "norm" in name and name.endswith("scale"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.05 * rng.standard_normal(shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port(cfg, variables, dtype=torch.float32, quant="none"):
    tcfg = tdino.DinoConfig(**{f: getattr(cfg, f) for f in (
        "hidden_size", "num_layers", "num_heads", "patch_size", "image_size",
        "mlp_ratio", "layerscale", "ln_eps", "pretrain_image_size")})
    model = tdino.DinoViT(tcfg, dtype=dtype, quant=quant)
    model.load_state_dict(dino_state_dict_from_jax(variables))
    return model.eval()


def _images(cfg, seed, n=2):
    return np.random.default_rng(seed).integers(
        0, 256, (n, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)


def _normalized(u8):
    return ((u8.astype(np.float32) / 255.0 - MEAN) / STD).astype(np.float32)


def _run_both(cfg, variables, u8, *, from_uint8, jdt, tdt, quant="none",
              **kw):
    jmodel = jdino.DinoViT(cfg, dtype=jdt, quant=quant)
    jx = (jnp.asarray(u8.reshape(len(u8), -1)) if from_uint8
          else jnp.asarray(_normalized(u8)))
    want = np.asarray(jmodel.apply(variables, jx, from_uint8=from_uint8, **kw),
                      np.float32)
    tx = (torch.from_numpy(u8.reshape(len(u8), -1)) if from_uint8
          else torch.from_numpy(_normalized(u8)))
    with torch.no_grad():
        got = _port(cfg, variables, tdt, quant)(tx, from_uint8=from_uint8, **kw)
    assert got.dtype == torch.float32
    return got.numpy(), want


def _cos_min(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                               * np.linalg.norm(b, axis=-1))).min()


def test_configs_equal_uml_tpu():
    assert tdino.DINO_CONFIGS.keys() == jdino.DINO_CONFIGS.keys()
    for name, (cfg, repo) in jdino.DINO_CONFIGS.items():
        tcfg, trepo = tdino.DINO_CONFIGS[name]
        assert trepo == repo
        assert vars(tcfg) == vars(cfg), name
        assert (tcfg.grid_size, tcfg.num_features) == (cfg.grid_size,
                                                       cfg.num_features)


OUTPUTS = {"token": {}, "mean": {"pool": "mean"},
           "tokens": {"return_tokens": True}}


@pytest.mark.parametrize("output", list(OUTPUTS))
@pytest.mark.parametrize("from_uint8", [True, False])
@pytest.mark.parametrize("patch,layerscale", [(14, True), (14, False),
                                              (8, True)])
def test_fp32_matches_uml_tpu(patch, layerscale, from_uint8, output):
    cfg = _config(patch, layerscale)
    variables = _variables(cfg, seed=patch + layerscale)
    got, want = _run_both(cfg, variables, _images(cfg, 1), from_uint8=from_uint8,
                          jdt=jnp.float32, tdt=torch.float32, **OUTPUTS[output])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FP32_ATOL


@pytest.mark.parametrize("output", ["token", "tokens"])
@pytest.mark.parametrize("patch", [14, 8])
def test_bf16_matches_uml_tpu(patch, output):
    cfg = _config(patch)
    variables = _variables(cfg, seed=10 + patch)
    got, want = _run_both(cfg, variables, _images(cfg, 2), from_uint8=True,
                          jdt=jnp.bfloat16, tdt=torch.bfloat16, **OUTPUTS[output])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_s257_matches_uml_tpu():
    """The DINOv2 sequence at 224 / 14 (S = 257, past the fused kernel's
    route on the card), fp32 and bf16."""
    cfg = _config(14, image_size=224)
    variables = _variables(cfg, seed=3)
    u8 = _images(cfg, 3)
    got, want = _run_both(cfg, variables, u8, from_uint8=True, jdt=jnp.float32,
                          tdt=torch.float32, return_tokens=True)
    assert got.shape == (2, 257, WIDTH)
    assert np.abs(got - want).max() <= FP32_ATOL
    got, want = _run_both(cfg, variables, u8, from_uint8=True, jdt=jnp.bfloat16,
                          tdt=torch.bfloat16)
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("output", ["token", "tokens"])
@pytest.mark.parametrize("patch,layerscale", [(14, True), (8, False)])
def test_int8_matches_uml_tpu(patch, layerscale, output):
    """quant="int8": every full block W8A8 with exact GELU, the CLS-only
    last block bf16, in both packages."""
    cfg = _config(patch, layerscale)
    variables = _variables(cfg, seed=20 + patch)
    got, want = _run_both(cfg, variables, _images(cfg, 4), from_uint8=True,
                          jdt=jnp.bfloat16, tdt=torch.bfloat16, quant="int8",
                          **OUTPUTS[output])
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _cos_min(got, want) >= MIN_COSINE


@pytest.mark.parametrize("rows", [34, 257])
def test_int8_mlp_integers_match_uml_tpu(rows):
    """The int8 MLP half's hidden with exact GELU, from the same int8
    operands: the port's two-pass plain form (q8_gemm's ROWMAX, then ACTQ)
    against uml_tpu's act quantization of the same pre-activation, with the
    jnp references' erf (integers within one step on at most 0.1%, scales
    rtol 1e-6) and with the Pallas kernel's sigmoid-quintic fit of GELU
    (max error 7.8e-5: within one step)."""
    rng = np.random.default_rng(rows)
    k, m = WIDTH, 4 * WIDTH
    xf = rng.standard_normal((rows, k)).astype(np.float32)
    w1 = (rng.standard_normal((k, m)) * k ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(m)).astype(np.float32)
    xq, xs = tq.ln_quantize_rows(torch.from_numpy(xf), 1e-6)
    w1q, w1sc = tq.quantize_weight(torch.from_numpy(w1))
    b1_t = torch.from_numpy(b1)
    rowmax = tgemm.q8_gemm(xq, w1q.t().contiguous(), xs[:, 0], w1sc, b1_t,
                           epi="ROWMAX")
    q, sc = tgemm.q8_gemm(xq, w1q.t().contiguous(), xs[:, 0], w1sc, b1_t,
                          epi="ACTQ", rowmax=rowmax, activation="gelu_exact")
    pre = jq._q8_dot(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()),
                     jnp.asarray(w1q.numpy()), jnp.asarray(w1sc.numpy()))
    pre = pre + jnp.asarray(b1)
    # the scales: rtol 1e-6 against erf; against the fit, its error (7.8e-5,
    # and the rounding of the fp32 quotient) / 127
    for table, share, tol in ((_ACTIVATIONS, FLIP_SHARE, dict(rtol=1e-6)),
                              (_KERNEL_ACTIVATIONS, 1.0,
                               dict(rtol=0, atol=8e-5 / 127))):
        jq_, js = jq._act_quantize_rows(pre, "gelu_exact", table)
        diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq_, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= share
        np.testing.assert_allclose(sc.numpy(), np.asarray(js)[:, 0], **tol)


def _hf_dinov2(patch, size, seed):
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    hf = Dinov2Model(Dinov2Config(
        hidden_size=WIDTH, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        image_size=size, patch_size=patch, initializer_range=0.1,
        layerscale_value=0.5)).eval()
    with torch.no_grad():   # LayerScale, LN and the embeddings off their inits
        for name, p in hf.named_parameters():
            if "lambda1" in name or name.endswith(("cls_token",
                                                   "position_embeddings")):
                p.add_(0.1 * torch.randn(p.shape))
            elif "norm" in name:
                p.add_(0.05 * torch.randn(p.shape))
    return hf


def _hf_vit(patch, size, seed):
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(seed)
    hf = ViTModel(ViTConfig(
        hidden_size=WIDTH, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        intermediate_size=4 * WIDTH, image_size=size, patch_size=patch,
        layer_norm_eps=1e-6, initializer_range=0.1),
        add_pooling_layer=False).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "layernorm" in name or name.endswith(("cls_token",
                                                     "position_embeddings")):
                p.add_(0.05 * torch.randn(p.shape))
    return hf


@pytest.mark.parametrize("family,patch", [("dinov2", 14), ("dino", 8)])
def test_matches_hf(family, patch):
    size = {14: 56, 8: 64}[patch]
    hf = (_hf_dinov2 if family == "dinov2" else _hf_vit)(patch, size, seed=patch)
    cfg = tdino.DinoConfig(WIDTH, LAYERS, HEADS, patch, image_size=size,
                           layerscale=family == "dinov2",
                           pretrain_image_size=size)
    model = tdino.DinoViT(cfg)
    model.load_state_dict(tdino.port_dinov2_state_dict(hf.state_dict(), cfg))
    u8 = np.random.default_rng(patch).integers(0, 256, (2, size, size, 3),
                                               dtype=np.uint8)
    x = torch.from_numpy(_normalized(u8))
    with torch.no_grad():
        ref = hf(pixel_values=x.permute(0, 3, 1, 2)).last_hidden_state.numpy()
        tokens = model(x, return_tokens=True).numpy()
        pooled = model(x).numpy()
        mean = model(x, pool="mean").numpy()
        from_u8 = model(torch.from_numpy(u8), from_uint8=True).numpy()
    assert np.abs(tokens - ref).max() <= FP32_ATOL
    assert np.abs(pooled - ref[:, 0]).max() <= FP32_ATOL
    assert np.abs(mean - ref[:, 1:].mean(1)).max() <= FP32_ATOL
    assert np.abs(from_u8 - ref[:, 0]).max() <= FP32_ATOL


@pytest.mark.parametrize("family", ["dinov2", "dino"])
def test_hf_port_equals_uml_tpu_port(family):
    """port_dinov2_state_dict of an HF checkpoint (position embeddings
    resampled from the pretrain grid) equals uml_tpu's port of it carried
    over by dino_state_dict_from_jax, bit for bit."""
    patch = 14 if family == "dinov2" else 8
    hf = (_hf_dinov2 if family == "dinov2" else _hf_vit)(patch, 6 * patch, seed=1)
    jcfg = jdino.DinoConfig(WIDTH, LAYERS, HEADS, patch, image_size=4 * patch,
                            layerscale=family == "dinov2",
                            pretrain_image_size=6 * patch)
    tcfg = tdino.DinoConfig(**vars(jcfg))
    sd = hf.state_dict()
    want = dino_state_dict_from_jax(jdino.port_dinov2_state_dict(sd, jcfg))
    got = tdino.port_dinov2_state_dict(sd, tcfg)
    assert got.keys() == want.keys()
    assert got["position_embeddings"].shape == (1, 17, WIDTH)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_interpolate_pos_embeddings_equals_uml_tpu():
    pos = np.random.default_rng(0).standard_normal((1, 1 + 37 ** 2, 16)).astype(
        np.float32)
    got = tdino.interpolate_pos_embeddings(pos, 37, 16)
    want = jdino.interpolate_pos_embeddings(pos, 37, 16)
    assert got.shape == (1, 1 + 16 ** 2, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])
    assert tdino.interpolate_pos_embeddings(pos, 37, 37) is pos


def test_load_dino_without_weights(monkeypatch):
    """No local checkpoint: load_dino raises unless allow_random_init, which
    draws seeded weights (two loads equal); an unknown quant mode raises."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(tdino.DINO_CONFIGS, "vit_small_patch14_dinov2.lvd142m",
                        (tdino.DinoConfig(WIDTH, 1, HEADS, 14, image_size=56),
                         "no-such-org/no-such-dinov2"))
    name = "vit_small_patch14_dinov2.lvd142m"
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        tdino.load_dino(name)
    a = tdino.load_dino(name, allow_random_init=True).state_dict()
    b = tdino.load_dino(name, allow_random_init=True, quant="int8").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.qkv.weight"], a["blocks.0.fc1.weight"][:384])
    with pytest.raises(ValueError, match="quant"):
        tdino.load_dino(name, allow_random_init=True, quant="int8_mlp")


def test_training_is_refused():
    """Training the int8 serving mode is refused (the int8 halves have no
    gradient): a forward that autograd would differentiate raises, frozen
    parameters run.  The bf16 / fp32 model trains (the full-model
    finetune, tests/test_torch_dino_train.py)."""
    cfg = _config(14)
    model = _port(cfg, _variables(cfg, seed=0), torch.bfloat16, quant="int8")
    u8 = torch.from_numpy(_images(cfg, 0).reshape(2, -1))
    with pytest.raises(RuntimeError, match="inference-only"):
        model(u8, from_uint8=True)
    model.requires_grad_(False)
    assert model(u8, from_uint8=True).shape == (2, WIDTH)
    model = _port(cfg, _variables(cfg, seed=0))
    model(u8, from_uint8=True).sum().backward()
    assert all(p.grad is not None for p in model.parameters())
