"""The features CLI of both packages on the same fixture and checkpoint.

A seeded tiny OpenAI-schema checkpoint is written as ViT-B-32.pt (patch
32 at resolution 224, so 50 positions; width 128 with 2 heads and 2
layers in each tower); both loaders infer that config from its shapes.
uml_tpu decodes with PIL here (its native decoder is switched off), as
the port does.  Labels, paths, prompts and EOT indices must be equal;
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

    monkeypatch.setattr(uml_tpu.native, "native_available", lambda: False)

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
