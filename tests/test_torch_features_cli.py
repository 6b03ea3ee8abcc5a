"""The features CLI of both packages on the same fixture and checkpoint.

A seeded tiny OpenAI-schema checkpoint is written as ViT-B-32.pt (patch
32 at resolution 224, so 50 positions; width 128 with 2 heads and 2
layers in each tower); both loaders infer that config from its shapes.
Both packages decode with PIL here (their native decoders switched off),
except in test_features_cli_native_decoder_agrees, where both run the
native libjpeg decoder (uml_tpu's built from its source into the test's
directory) and the caches must say so.  Labels, paths, prompts and EOT
indices must be equal;
the features, bf16 in both packages, must agree to a per-row cosine of
0.999 (the packages round intermediates to bf16 at different points), in
bf16 and in the int8 serving mode (``--quant int8``; the integers of the
two packages can differ by a step where those roundings meet a tie).
The port runs on the CPU (``UML_TORCH_DEVICE=cpu``).
"""

import numpy as np
import pytest
import torch

from tests.test_data_fewshot import make_caltech_fixture
from tests.test_torch_native import jax_native, native_on  # noqa: F401
from uml_tpu.cli import features as jax_features
from uml_tpu.cli import generate_fewshot as gf
from uml_tpu.data.feature_cache import img_outdir, load_cache, text_outdir
from uml_tpu_torch.cli import features as torch_features
from uml_tpu_torch.models.clip import CLIP, ClipConfig

MIN_COSINE = 0.999
TINY_B32 = ClipConfig(embed_dim=64, image_resolution=224, vision_layers=2,
                      vision_width=128, vision_patch_size=32,
                      transformer_width=128, transformer_heads=2,
                      transformer_layers=2)


def _cosine_min(a, b):
    a = a.reshape(-1, a.shape[-1])
    b = b.reshape(-1, b.shape[-1])
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                               * np.linalg.norm(b, axis=-1))).min()


@pytest.mark.heavy
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_features_cli_caches_agree(tmp_path, monkeypatch, return_tokens,
                                   quant):
    torch.set_num_threads(1)
    root = make_caltech_fixture(str(tmp_path / "data"))
    weights = tmp_path / "weights"
    weights.mkdir()
    model = CLIP(TINY_B32).init_random(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), str(weights / "ViT-B-32.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    import uml_tpu.native
    import uml_tpu_torch.native

    monkeypatch.setattr(uml_tpu.native, "native_available", lambda: False)
    monkeypatch.setattr(uml_tpu_torch.native, "native_available", lambda: False)

    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    argv = ["--data_dir", root, "--indices_dir", f"{root}/indices",
            "--dataset", "caltech101", "--clip-encoder", "ViT-B/32",
            "--train-shot", "2", "--seed", "1", "--text-augmentation",
            "hand_crafted", "--batch-size", "8", "--num-workers", "2",
            "--mesh", "off", "--quant", quant] + (
                ["--return_tokens"] if return_tokens else [])
    dirs = {}
    for name, cli in (("jax", jax_features), ("torch", torch_features)):
        dirs[name] = str(tmp_path / f"features_{name}")
        args = cli.build_parser().parse_args(argv + ["--feature_dir",
                                                     dirs[name]])
        args.overwrite, args.force_rerun = False, False
        cli.main(args)

    def caches(d):
        return (load_cache(img_outdir(d, "ViT-B/32", "caltech101", "crop", 2,
                                      1, "train", return_tokens)),
                load_cache(img_outdir(d, "ViT-B/32", "caltech101", "crop", 2,
                                      1, "test", return_tokens)),
                load_cache(text_outdir(d, "ViT-B/32", "caltech101",
                                       "hand_crafted", return_tokens)))

    (jtr, jte, jtx), (ttr, tte, ttx) = caches(dirs["jax"]), caches(dirs["torch"])
    for j, t in ((jtr["train"], ttr["train"]), (jtr["val"], ttr["val"]),
                 (jte, tte)):
        np.testing.assert_array_equal(t["labels"], j["labels"])
        assert t["paths"] == j["paths"] and t["decoder"] == j["decoder"] == "pil"
        assert t["features"].shape == j["features"].shape
        assert _cosine_min(t["features"], j["features"]) >= MIN_COSINE
    assert ttr["lab2cname"] == jtr["lab2cname"]
    np.testing.assert_array_equal(ttx["labels"], jtx["labels"])
    np.testing.assert_array_equal(ttx["eot_indices"], jtx["eot_indices"])
    assert ttx["prompts"] == jtx["prompts"]
    assert ttx["lab2cname"] == jtx["lab2cname"]
    assert ttx["features"].shape == jtx["features"].shape
    assert _cosine_min(ttx["features"], jtx["features"]) >= MIN_COSINE


@pytest.mark.heavy
def test_features_cli_native_decoder_agrees(tmp_path, monkeypatch, jax_native):
    """Both packages with their native decoders on, as a default run on a
    machine with g++ and libjpeg goes (``--image_augmentation crop``):
    the caches say ``decoder: "native-libjpeg"`` on both sides and agree.
    uml_tpu's library is built from its source into ``tmp_path``."""
    torch.set_num_threads(1)
    root = make_caltech_fixture(str(tmp_path / "data"))
    weights = tmp_path / "weights"
    weights.mkdir()
    model = CLIP(TINY_B32).init_random(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), str(weights / "ViT-B-32.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    argv = ["--data_dir", root, "--indices_dir", f"{root}/indices",
            "--dataset", "caltech101", "--clip-encoder", "ViT-B/32",
            "--train-shot", "2", "--seed", "1", "--text-augmentation",
            "hand_crafted", "--batch-size", "8", "--num-workers", "2",
            "--mesh", "off"]
    dirs = {}
    for name, cli in (("jax", jax_features), ("torch", torch_features)):
        dirs[name] = str(tmp_path / f"features_{name}")
        args = cli.build_parser().parse_args(argv + ["--feature_dir", dirs[name]])
        args.overwrite, args.force_rerun = False, False
        cli.main(args)
    for mode in ("train", "test"):
        j, t = (load_cache(img_outdir(dirs[n], "ViT-B/32", "caltech101", "crop",
                                      2, 1, mode)) for n in ("jax", "torch"))
        for jj, tt in ((j["train"], t["train"]), (j["val"], t["val"])) \
                if mode == "train" else ((j, t),):
            assert tt["decoder"] == jj["decoder"] == "native-libjpeg"
            assert tt["paths"] == jj["paths"]
            assert _cosine_min(tt["features"], jj["features"]) >= MIN_COSINE


DINO = "vit_base_patch14_dinov2.lvd142m"
LM = "bert-base-uncased"


def tiny_dino(monkeypatch):
    """Both packages' DINO loaders on one tiny seeded HF Dinov2Model (width
    128, 2 layers, 2 heads, patch 14, position embeddings for a 112-pixel
    grid, resampled to 224 by both porters) in place of DINO's published
    config, the HF load step monkeypatched to return it; the HF language
    model absent, as on a machine without its files (uml_tpu's TextModel
    raises the OSError of an offline load, the port's looks in the local
    cache only)."""
    import transformers
    from transformers import Dinov2Config, Dinov2Model

    from uml_tpu.models import dino as jdino
    from uml_tpu.models import languagemodel as jlm
    from uml_tpu_torch.models import dino as tdino

    torch.manual_seed(0)
    hf = Dinov2Model(Dinov2Config(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        image_size=112, patch_size=14, initializer_range=0.1,
        layerscale_value=0.5)).eval()
    kw = dict(image_size=224, pretrain_image_size=112)
    monkeypatch.setitem(jdino.DINO_CONFIGS, DINO,
                        (jdino.DinoConfig(128, 2, 2, 14, **kw), "tiny/dinov2"))
    monkeypatch.setitem(tdino.DINO_CONFIGS, DINO,
                        (tdino.DinoConfig(128, 2, 2, 14, **kw), "tiny/dinov2"))
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained",
                        staticmethod(lambda repo, **_: hf))

    def offline(name, *_, **__):
        raise OSError(f"{name}: not in the local HF cache")

    monkeypatch.setattr(jlm, "TextModel", offline)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.mark.heavy
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_features_cli_dino_caches_agree(tmp_path, monkeypatch, return_tokens,
                                        quant):
    """--vision_model (DINOv2 at S = 257, exact GELU, eps 1e-6) with
    --language_model and --allow_random_init: the image caches agree to a
    per-row cosine of 0.999 in bf16 and int8; the text caches (hash-random
    features, in one process) are equal."""
    torch.set_num_threads(1)
    root = make_caltech_fixture(str(tmp_path / "data"))
    tiny_dino(monkeypatch)
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    import uml_tpu.native
    import uml_tpu_torch.native

    monkeypatch.setattr(uml_tpu.native, "native_available", lambda: False)
    monkeypatch.setattr(uml_tpu_torch.native, "native_available", lambda: False)
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    argv = ["--data_dir", root, "--indices_dir", f"{root}/indices",
            "--dataset", "caltech101", "--vision_model", DINO,
            "--language_model", LM, "--allow-random-init",
            "--train-shot", "2", "--seed", "1", "--text-augmentation",
            "hand_crafted", "--batch-size", "8", "--num-workers", "2",
            "--mesh", "off", "--quant", quant] + (
                ["--return_tokens"] if return_tokens else [])
    dirs = {}
    for name, cli in (("jax", jax_features), ("torch", torch_features)):
        dirs[name] = str(tmp_path / f"features_{name}")
        args = cli.build_parser().parse_args(argv + ["--feature_dir",
                                                     dirs[name]])
        args.overwrite, args.force_rerun = False, False
        cli.main(args)

    def caches(d):
        return (load_cache(img_outdir(d, DINO, "caltech101", "crop", 2, 1,
                                      "train", return_tokens)),
                load_cache(img_outdir(d, DINO, "caltech101", "crop", 2, 1,
                                      "test", return_tokens)),
                load_cache(text_outdir(d, LM, "caltech101", "hand_crafted",
                                       return_tokens)))

    (jtr, jte, jtx), (ttr, tte, ttx) = caches(dirs["jax"]), caches(dirs["torch"])
    for j, t in ((jtr["train"], ttr["train"]), (jtr["val"], ttr["val"]),
                 (jte, tte)):
        np.testing.assert_array_equal(t["labels"], j["labels"])
        assert t["paths"] == j["paths"] and t["decoder"] == j["decoder"] == "pil"
        assert t["features"].shape == j["features"].shape
        assert t["features"].shape[1:] == ((257, 128) if return_tokens else (128,))
        assert _cosine_min(t["features"], j["features"]) >= MIN_COSINE
    assert ttr["lab2cname"] == jtr["lab2cname"]
    for key in ("labels", "eot_indices", "features"):
        np.testing.assert_array_equal(ttx[key], jtx[key])
    assert ttx["prompts"] == jtx["prompts"]
    assert ttx["lab2cname"] == jtx["lab2cname"]
