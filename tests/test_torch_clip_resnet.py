"""The port's CLIP RN50 / RN101 (models/clip_resnet.py, ClipResNetModel)
against uml_tpu's on the CPU.

uml_tpu's flax variables, their BatchNorm leaves redrawn near the identity
(so the port's BN fold is exercised), are carried into the port by
``convert.state_dict_from_jax``.  fp32: max |port - uml_tpu| <= 1e-4 x
max |uml_tpu|, for ModifiedResNet at stages (1, 1, 1, 1) width 16 and
resolution 64, and at RN50's widths (width 64: 2048 channels into a
32-head attention pool) with its stages cut to (1, 1, 1, 1), at 224 on 2
images; with ``return_tokens``; for ``encode_image_u8`` on flat and 4-d
uint8 and for ``encode_text``.  An OpenAI-schema RN state_dict made in
code (BatchNorm's ``num_batches_tracked`` included) is read by both
packages' checkpoint readers.

The features CLI with no ``--clip-encoder`` (RN50, the default) runs on
a tiny RN50-schema checkpoint (stages (1, 1, 1, 1), width 16, RN50's
output width 1024; a 1-layer text tower of width 128) in both packages,
both decoding with the native libjpeg decoder: the caches agree to a
per-row cosine of 0.999 in bf16 (the bound of
tests/test_torch_features_cli.py) and say ``decoder: "native-libjpeg"``;
under ``--quant int8`` the port's caches equal its bf16 ones (the RN
models ignore the mode).  The frozen finetune then runs on those caches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data_fewshot import make_caltech_fixture
from tests.test_torch_features_cli import MIN_COSINE, _cosine_min
from tests.test_torch_native import jax_native, native_on  # noqa: F401
from uml_tpu.cli import features as jax_features
from uml_tpu.cli import generate_fewshot as gf
from uml_tpu.data.feature_cache import img_outdir, load_cache, text_outdir
from uml_tpu.models import clip as jclip
from uml_tpu.models import clip_resnet as jrn
from uml_tpu.models import port_torch as jport
from uml_tpu_torch.cli import features as torch_features
from uml_tpu_torch.cli import finetune as torch_ft
from uml_tpu_torch.models import clip as tclip
from uml_tpu_torch.models import clip_resnet as trn
from uml_tpu_torch.models import port_torch as tport
from uml_tpu_torch.models.convert import resnet_state_dict_from_jax, state_dict_from_jax
from uml_tpu_torch.models.tokenizer import tokenize

REL = 1e-4
TINY_RN = dict(layers=(1, 1, 1, 1), output_dim=64, width=16, image_resolution=64)
RN50_WIDTHS = dict(layers=(1, 1, 1, 1), output_dim=1024, width=64,
                   image_resolution=224)
TEXT = dict(transformer_width=128, transformer_heads=2, transformer_layers=1)
PROMPTS = ["a photo of a cat.", "a bad photo of the Boeing 737-800.", "x"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _assert_rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _redraw_bn(tree, rng):
    """Every BatchNorm leaf of a flax tree (numpy) drawn near the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            n = v["scale"].shape
            out[k] = {"scale": (1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
                      "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
                      "mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                      "var": (1 + 0.2 * rng.random(n)).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _redraw_bn(v, rng)
        else:
            out[k] = v
    return out


def _jax_resnet(cfg_kw, seed=0):
    cfg = jrn.ClipResNetConfig(**cfg_kw)
    model = jrn.ModifiedResNet(cfg, dtype=jnp.float32)
    r = cfg.image_resolution
    v = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, r, r, 3), jnp.float32))
    params = _redraw_bn(jax.tree.map(np.asarray, v["params"]),
                        np.random.default_rng(seed))
    return cfg, model, {"params": params}


def _port_resnet(cfg, variables):
    port = trn.ModifiedResNet(trn.ClipResNetConfig(**vars(cfg)))
    sd = resnet_state_dict_from_jax(variables["params"], prefix="")
    port.load_state_dict(sd)
    return port


@pytest.mark.parametrize("return_tokens", [False, True])
@pytest.mark.parametrize("cfg_kw", [TINY_RN, RN50_WIDTHS], ids=["tiny", "rn50_widths"])
def test_modified_resnet_matches_uml_tpu(cfg_kw, return_tokens):
    cfg, jmodel, variables = _jax_resnet(cfg_kw)
    port = _port_resnet(cfg, variables)
    r = cfg.image_resolution
    x = np.random.default_rng(1).standard_normal((2, r, r, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), return_tokens=return_tokens)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.float32, return_tokens=return_tokens)
    if return_tokens:
        assert got.shape == (2, (r // 32) ** 2, cfg.width * 32)
    _assert_rel(got, want)


def test_frozen_batch_norm_eval_form():
    bn = trn.FrozenBatchNorm(5)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(5, generator=g))
        bn.running_var.copy_(torch.rand(5, generator=g) + 0.5)
    x = torch.randn(2, 5, 3, 3, generator=g)
    want = ((x - bn.running_mean[:, None, None])
            / torch.sqrt(bn.running_var[:, None, None] + 1e-5)
            * bn.weight[:, None, None] + bn.bias[:, None, None])
    torch.testing.assert_close(bn(x), want, rtol=1e-6, atol=1e-6)


def _jax_clip_resnet(rn_kw, seed=0):
    rn = jrn.ClipResNetConfig(**rn_kw)
    text = jclip.ClipConfig(embed_dim=rn.output_dim, image_resolution=rn.image_resolution,
                            vision_layers=0, vision_width=rn.width,
                            vision_patch_size=0, **TEXT)
    model = jclip.ClipResNetModel(rn, text, dtype=jnp.float32)
    r = rn.image_resolution
    v = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, r, r, 3), jnp.float32),
                            jnp.zeros((1, 77), jnp.int32))
    params = jax.tree.map(np.asarray, v["params"])
    params["visual"] = _redraw_bn(params["visual"], np.random.default_rng(seed))
    return model, {"params": params}


def _port_clip_resnet(rn_kw):
    rn = trn.ClipResNetConfig(**rn_kw)
    text = tclip.ClipConfig(embed_dim=rn.output_dim, image_resolution=rn.image_resolution,
                            vision_layers=0, vision_width=rn.width,
                            vision_patch_size=0, **TEXT)
    return tclip.ClipResNetModel(rn, text, dtype=torch.float32)


@pytest.fixture(scope="module")
def clip_pair():
    jmodel, variables = _jax_clip_resnet(TINY_RN)
    port = _port_clip_resnet(TINY_RN)
    port.load_state_dict(state_dict_from_jax(variables))
    return jmodel, variables, port


@pytest.mark.parametrize("layout", ["flat", "4d"])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_encode_image_u8_matches(clip_pair, layout, return_tokens):
    jmodel, variables, port = clip_pair
    u8 = np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    if layout == "flat":
        u8 = u8.reshape(3, -1)
    want = jmodel.apply(variables, jnp.asarray(u8), method=lambda m, x:
                        m.encode_image_u8(x, return_tokens=return_tokens))
    with torch.no_grad():
        got = port.encode_image_u8(torch.from_numpy(u8), return_tokens=return_tokens)
    _assert_rel(got, want)


def test_encode_text_matches(clip_pair):
    jmodel, variables, port = clip_pair
    toks = tokenize(PROMPTS)
    want, want_eot = jmodel.apply(variables, jnp.asarray(toks), method=lambda m, t:
                                  m.encode_text(t, return_eot=True))
    with torch.no_grad():
        got, eot = port.encode_text(torch.from_numpy(toks.astype(np.int64)),
                                    return_eot=True)
    np.testing.assert_array_equal(eot.numpy(), np.asarray(want_eot))
    _assert_rel(got, want)


def _openai_rn_state_dict(rn_kw, seed):
    """An OpenAI-schema RN CLIP state_dict made in code: the port's random
    init, plus the entries a torch BatchNorm2d and the OpenAI archive
    carry that no module reads."""
    model = _port_clip_resnet(rn_kw).init_random(torch.Generator().manual_seed(seed))
    sd = dict(model.state_dict())
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    sd.update(input_resolution=torch.tensor(rn_kw["image_resolution"]),
              context_length=torch.tensor(77), vocab_size=torch.tensor(49408))
    return sd


def test_openai_schema_checkpoint_loads_in_both_packages(tmp_path):
    path = str(tmp_path / "RN50.pt")
    torch.save(_openai_rn_state_dict(TINY_RN, 3), path)
    jmodel, variables = jport.load_clip_checkpoint(path)
    port = tport.load_clip_checkpoint(path)
    assert isinstance(jmodel, jclip.ClipResNetModel)
    assert isinstance(port, tclip.ClipResNetModel)
    assert vars(port.resnet_config) == vars(jmodel.resnet_config)
    assert port.config.transformer_width == jmodel.text_config.transformer_width
    u8 = np.random.default_rng(4).integers(0, 256, (2, 64 * 64 * 3), dtype=np.uint8)
    toks = tokenize(PROMPTS)
    with torch.no_grad():
        got_i = port.encode_image_u8(torch.from_numpy(u8))
        got_t = port.encode_text(torch.from_numpy(toks.astype(np.int64)))
    _assert_rel(got_i, jmodel.apply(variables, jnp.asarray(u8),
                                    method=lambda m, x: m.encode_image_u8(x)))
    _assert_rel(got_t, jmodel.apply(variables, jnp.asarray(toks),
                                    method=lambda m, t: m.encode_text(t)))
    # an int8 serving mode builds the RN model as it is
    q = tport.load_clip_checkpoint(path, quant="int8")
    assert q.quant == "none"
    with torch.no_grad():
        assert torch.equal(q.encode_image_u8(torch.from_numpy(u8)), got_i)


@pytest.mark.parametrize("name", ["RN50", "RN101", "ViT-B/16", "ViT-B/32"])
def test_embed_dim_and_build_clip_names(name):
    assert tclip.clip_embed_dim(name) == jclip.clip_embed_dim(name)
    port = tclip.build_clip(name, quant="int8")
    jmodel = jclip.build_clip(name, quant="int8")
    assert port.embed_dim == jmodel.embed_dim == tclip.clip_embed_dim(name)
    if name.startswith("RN"):
        assert isinstance(port, tclip.ClipResNetModel) and port.quant == "none"
        assert port.resnet_config == trn.CLIP_RESNET_CONFIGS[name]
        assert (port.config.transformer_width, port.config.transformer_heads,
                port.config.transformer_layers) == (512, 8, 12)
        r = jmodel.resnet_config.image_resolution
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                                jnp.zeros((1, r, r, 3)), jnp.zeros((1, 77), jnp.int32))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        assert sum(t.numel() for t in port.state_dict().values()) == n_jax
    with pytest.raises(ValueError, match="Unknown"):
        tclip.build_clip("RN50x4")


RN50_TINY_CKPT = dict(layers=(1, 1, 1, 1), output_dim=1024, width=16,
                      image_resolution=224)


def _caches(d, return_tokens=False):
    return (load_cache(img_outdir(d, "RN50", "caltech101", "crop", 2, 1, "train",
                                  return_tokens)),
            load_cache(img_outdir(d, "RN50", "caltech101", "crop", 2, 1, "test",
                                  return_tokens)),
            load_cache(text_outdir(d, "RN50", "caltech101", "hand_crafted",
                                   return_tokens)))


@pytest.mark.heavy
def test_features_default_encoder_caches_agree(tmp_path, monkeypatch, jax_native):
    """``features`` with no --clip-encoder (RN50) on the CPU in both
    packages, native decoding on both sides; then the port with --quant
    int8 (equal to its bf16 caches) and the frozen finetune on them."""
    root = make_caltech_fixture(str(tmp_path / "data"))
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(_openai_rn_state_dict(RN50_TINY_CKPT, 5), str(weights / "RN50.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    argv = ["--data_dir", root, "--indices_dir", f"{root}/indices",
            "--dataset", "caltech101", "--train-shot", "2", "--seed", "1",
            "--text-augmentation", "hand_crafted", "--batch-size", "8",
            "--num-workers", "2", "--mesh", "off"]
    dirs = {}
    for name, cli, quant in (("jax", jax_features, "none"),
                             ("torch", torch_features, "none"),
                             ("torch_int8", torch_features, "int8")):
        dirs[name] = str(tmp_path / f"features_{name}")
        args = cli.build_parser().parse_args(
            argv + ["--feature_dir", dirs[name], "--quant", quant])
        assert args.clip_encoder == "RN50"
        args.overwrite, args.force_rerun = False, False
        cli.main(args)
    (jtr, jte, jtx), (ttr, tte, ttx) = _caches(dirs["jax"]), _caches(dirs["torch"])
    for j, t in ((jtr["train"], ttr["train"]), (jtr["val"], ttr["val"]), (jte, tte)):
        np.testing.assert_array_equal(t["labels"], j["labels"])
        assert t["paths"] == j["paths"]
        assert t["decoder"] == j["decoder"] == "native-libjpeg"
        assert t["features"].shape == j["features"].shape
        assert t["features"].shape[1] == 1024
        assert _cosine_min(t["features"], j["features"]) >= MIN_COSINE
    np.testing.assert_array_equal(ttx["eot_indices"], jtx["eot_indices"])
    assert ttx["prompts"] == jtx["prompts"]
    assert _cosine_min(ttx["features"], jtx["features"]) >= MIN_COSINE
    for a, b in zip(_caches(dirs["torch"]), _caches(dirs["torch_int8"])):
        for split in ("train", "val") if "train" in a else (None,):
            x, y = (a[split], b[split]) if split else (a, b)
            np.testing.assert_array_equal(x["features"], y["features"])

    exp = str(tmp_path / "experiments")
    args = torch_ft.build_parser().parse_args(argv[:-4] + [
        "--feature_dir", dirs["torch"], "--result_dir", exp,
        "--text_type", "hand_crafted", "--modality", "crossmodal",
        "--alpha", "0.5", "--hyperparams", "smoke", "--quant", "int8"])
    args.overwrite, args.force_rerun = False, False
    torch_ft.main(args)
    (path,) = [os.path.join(d, f) for d, _, files in os.walk(exp) for f in files
               if f == "test_result.pth"]
    assert os.sep + "RN50" + os.sep in path
    result = load_cache(path)
    assert np.isfinite(result["test_acc"]) and np.isfinite(result["val_acc"])
    assert np.asarray(result["model"]["head_w"]).shape == (1024, 4)
