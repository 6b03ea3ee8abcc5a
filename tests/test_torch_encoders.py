"""Encoder loading, the features CLI's refusals, and the kernel build's
failure mode on a machine without the CUDA toolkit (all on the CPU)."""

import hashlib

import pytest
import torch

from uml_tpu_torch.cli import features
from uml_tpu_torch.models import encoders
from uml_tpu_torch.models.clip import CLIP, ClipConfig
from uml_tpu_torch.ops import _build

TINY = ClipConfig(embed_dim=64, image_resolution=64, vision_layers=1,
                  vision_width=128, vision_patch_size=32,
                  transformer_width=128, transformer_heads=2,
                  transformer_layers=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_load_clip_without_weights_raises(monkeypatch):
    monkeypatch.delenv("UML_CLIP_WEIGHTS_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="allow-random-init"):
        encoders.load_clip("ViT-B/16")


def test_random_init_is_seeded():
    a = CLIP(TINY).init_random(torch.Generator().manual_seed(0)).state_dict()
    b = CLIP(TINY).init_random(torch.Generator().manual_seed(0)).state_dict()
    c = CLIP(TINY).init_random(torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.proj"], c["visual.proj"])


def test_checkpoint_loads_with_sha_check(tmp_path, monkeypatch):
    """A local ViT-B-32.pt loads by config inference; a known name whose
    digest mismatches is refused unless UML_CLIP_VERIFY_SHA=0."""
    model = CLIP(TINY).init_random(torch.Generator().manual_seed(2))
    path = tmp_path / "ViT-B-32.pt"
    torch.save(model.state_dict(), str(path))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "1")
    with pytest.raises(RuntimeError, match="SHA256"):
        encoders.load_clip("ViT-B/32")
    monkeypatch.setattr(encoders, "CLIP_SHA256", {
        "ViT-B/32": hashlib.sha256(path.read_bytes()).hexdigest()})
    loaded = encoders.load_clip("ViT-B/32", dtype=torch.float32)
    assert loaded.config == TINY
    sd = loaded.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("flags,message", [
    (["--vision_model", "vit_base_patch16_224_dino"], "not ported"),
    (["--language_model", "gpt2"], "not ported"),
    (["--clip-encoder", "ViT-B/16", "--quant", "int8"], "int8"),
    (["--clip-encoder", "RN50"], "RN towers"),
])
def test_features_refuses_what_is_not_ported(flags, message):
    args = features.build_parser().parse_args(
        ["--clip-encoder", "ViT-B/16"] + flags)
    with pytest.raises(SystemExit, match=message):
        features.main(args)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No CUDA toolkit: the first launch fails loudly, at build time."""
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
