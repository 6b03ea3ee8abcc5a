"""Encoder loading, the default device, the features CLI's refusals, and
the kernel build's failure mode on a machine without the CUDA toolkit
(all on the CPU)."""

import hashlib

import numpy as np
import pytest
import torch

from uml_tpu_torch.cli import features, finetune
from uml_tpu_torch.core import device
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


@pytest.mark.parametrize("cli,flags,message", [
    # uml_tpu's early refusal of a mixed int8 mode for a non-CLIP tower
    (features, ["--vision_model", "vit_base_patch16_224_dino", "--quant",
                "int8_qkv"], "int8_qkv"),
])
def test_features_refuses_what_is_not_ported(monkeypatch, cli, flags, message):
    """Each refusal comes before any dataset or model work."""
    args = cli.build_parser().parse_args(["--clip-encoder", "ViT-B/16"] + flags)
    with pytest.raises(SystemExit, match=message):
        cli.main(args)


@pytest.mark.parametrize("cli,flags", [
    # mid-run checkpoints of the finetune, with the DINO full-model grid
    # (tests/test_torch_checkpoint.py resumes such runs)
    (finetune, ["--vision_model", "vit_base_patch16_224_dino",
                "--hyperparams", "smoke_full", "--ckpt_every", "5"]),
    # an HF language model whose files are local: the port runs it
    # (tests/test_torch_languagemodel.py)
    (features, ["--language_model", "gpt2", "--allow-random-init"]),
    # the RN towers' full-model finetune, BatchNorm in train mode
    # (tests/test_torch_clip_resnet_train.py)
    (finetune, ["--clip-encoder", "RN50", "--hyperparams", "smoke_full"]),
], ids=["ckpt_every", "language_model", "rn_smoke_full"])
def test_formerly_refused_flags_are_accepted(cli, flags):
    """What the port refused before the RN full-model finetune, the HF
    language models and the checkpoints landed passes the early check."""
    args = cli.build_parser().parse_args(["--clip-encoder", "ViT-B/16"] + flags)
    cli.check_ported(args)


def test_default_device_is_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    """No card: default_device() raises (no quiet CPU fallback) unless
    UML_TORCH_DEVICE=cpu asks for the CPU; a card gives cuda."""
    monkeypatch.delenv("UML_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="UML_TORCH_DEVICE=cpu"):
        device.default_device()
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    assert device.default_device() == torch.device("cpu")
    monkeypatch.setenv("UML_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError, match="UML_TORCH_DEVICE"):
        device.default_device()
    monkeypatch.delenv("UML_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.default_device() == torch.device("cuda")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No CUDA toolkit: the first launch fails loudly, at build time."""
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_language_model_without_local_files(monkeypatch):
    """No local files for the HF language model: the adapter raises the
    load error uml_tpu's TextModel raises there, and under
    allow_random_init takes hash-random 768-wide text features (indices:
    the prompts' lengths); with no vision model it encodes no image."""
    import transformers

    def offline(name, **kw):
        assert kw.get("local_files_only") is True
        raise OSError(f"{name}: not in the local HF cache")

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(offline))
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    with pytest.raises(OSError, match="local HF cache"):
        features._HFEncoderAdapter(language_model="gpt2")
    enc = features._HFEncoderAdapter(language_model="gpt2", allow_random_init=True)
    feats, idx = enc.encode_texts(["a cat", "a dog."])
    assert feats.shape == (2, 768) and feats.dtype == np.float32
    assert idx.tolist() == [5, 6]
    with pytest.raises(RuntimeError, match="vision model"):
        enc.stage_images(np.zeros((1, 224, 224, 3), np.uint8))
