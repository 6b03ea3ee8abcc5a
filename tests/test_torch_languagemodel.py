"""The port's TextModel (uml_tpu_torch/models/languagemodel.py) and the
features CLI's ``--language_model`` against uml_tpu's on the CPU.

Every model is made in code with seeded weights and saved to a local
directory whose name holds its family key (``llama``, ``bert``, ``gpt2``:
``model_family`` and the backend choice read the name); both packages
load it from there, so nothing reaches the network.

* LLaMA (tests/test_llama.py's tiny checkpoint): the native backend in
  fp32 and int8_w against uml_tpu's native backend, at 2e-5.
* BERT (CLS row) and GPT-2 (pad = eos, masked mean): HF's torch model in
  the port, HF's Flax port (or torch model) in uml_tpu, at 1e-5;
  ``return_tokens`` too.
* ``TextModel.native`` (no tokenizer, no ``transformers``) and
  ``encode_ids`` equal ``encode``.
* ``features --vision_model <tiny DINO> --language_model <local dir>``,
  with and without ``--quant int8``: the text caches (features, labels,
  eot_indices) of both packages agree; ``--quant int8_qkv`` maps to
  int8_w on the adapter.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_data_fewshot import make_caltech_fixture
from tests.test_llama import _save_tiny_llama
from uml_tpu.models import languagemodel as jlm
from uml_tpu_torch.models import languagemodel as tlm

TEXTS = ["a photo of cat", "the dog", "a photo of the dog"]
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _offline_cpu(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")


def _word_vocab():
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for i, w in enumerate(["a", "photo", "of", "cat", "dog", "the", "itap",
                           "centered", "satellite"]):
        vocab[w] = 3 + i
    return vocab


def _save_tiny_gpt2(d):
    """A tiny seeded HF GPT2Model and a word-level tokenizer with an eos
    token and no pad token (the decoder takes pad := eos)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import GPT2Config, GPT2Model, PreTrainedTokenizerFast

    torch.manual_seed(2)
    GPT2Model(GPT2Config(vocab_size=64, n_embd=32, n_layer=2, n_head=2,
                         n_positions=64)).save_pretrained(d)
    tok = Tokenizer(WordLevel(_word_vocab(), unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            bos_token="<s>", eos_token="</s>").save_pretrained(d)


def _save_tiny_bert(d):
    """A tiny seeded HF BertModel and a WordPiece tokenizer from a vocab
    file written here."""
    from transformers import BertConfig, BertModel, BertTokenizerFast

    os.makedirs(d, exist_ok=True)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(_word_vocab())[3:]
    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(words) + "\n")
    torch.manual_seed(3)
    BertModel(BertConfig(vocab_size=len(words), hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=64)).save_pretrained(d)
    BertTokenizerFast(vocab_file=vocab).save_pretrained(d)


SAVERS = {"llama": _save_tiny_llama, "bert": _save_tiny_bert, "gpt2": _save_tiny_gpt2}


def _assert_close(got, want, atol):
    got_f, got_i = got
    want_f, want_i = want
    assert got_f.dtype == np.float32 and got_f.shape == np.shape(want_f)
    np.testing.assert_allclose(got_f, np.asarray(want_f, np.float32), atol=atol,
                               rtol=atol)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("family,quant", [("llama", "none"), ("llama", "int8_w"),
                                          ("bert", "none"), ("gpt2", "none")])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_text_model_matches_uml_tpu(tmp_path, family, quant, return_tokens):
    d = str(tmp_path / f"tiny-{family}")
    SAVERS[family](d)
    want_model = jlm.TextModel(d, quant=quant)
    got_model = tlm.TextModel(d, quant=quant)
    assert got_model.backend == ("native" if family == "llama" else "torch")
    # uml_tpu runs HF's Flax port where it loads, else HF's torch model
    assert want_model.backend in (("native",) if family == "llama"
                                  else ("flax", "torch"))
    assert got_model.hidden_size == want_model.hidden_size
    assert got_model.device == torch.device("cpu")
    if family == "gpt2":
        assert got_model.tokenizer.pad_token == "</s>"
    if quant == "int8_w":
        q = got_model.model.layers[0].self_attn["q_proj"]
        assert q.kernel_q8.dtype == torch.int8
    want = want_model.encode(TEXTS, return_tokens=return_tokens)
    got = got_model.encode(TEXTS, return_tokens=return_tokens)
    _assert_close(got, want, ATOL if family == "llama" else 1e-5)
    if not return_tokens:
        assert got[1].tolist() == [len(t) for t in TEXTS]


def test_native_from_state_dict_without_a_tokenizer(tmp_path):
    """``TextModel.native`` over the port's state_dict gives what the
    HF-loaded native model gives, by ``encode_ids`` on the tokenizer's ids;
    int8_w quantizes where the weights lie."""
    d = str(tmp_path / "tiny-llama")
    _save_tiny_llama(d)
    loaded = tlm.TextModel(d)
    batch = loaded.tokenizer(TEXTS, padding=True, return_tensors="np")
    sd = {k: v.clone() for k, v in loaded.model.state_dict().items()}
    bare = tlm.TextModel.native(loaded.config, sd)
    assert bare.tokenizer is None and bare.backend == "native"
    got = bare.encode_ids(batch["input_ids"], batch["attention_mask"])
    want, _ = loaded.encode(TEXTS)
    np.testing.assert_array_equal(got.numpy(), want)
    q8 = tlm.TextModel.native(loaded.config, sd, quant="int8_w")
    qf = q8.encode_ids(batch["input_ids"], batch["attention_mask"]).numpy()
    cos = (qf * want).sum(-1) / (np.linalg.norm(qf, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.995


def test_adapter_maps_int8_modes_to_weight_only(tmp_path):
    from uml_tpu_torch.cli import features

    d = str(tmp_path / "tiny-llama")
    _save_tiny_llama(d)
    assert features._HFEncoderAdapter(language_model=d,
                                      quant="int8_qkv").text_model.quant == "int8_w"
    assert features._HFEncoderAdapter(language_model=d,
                                      quant="none").text_model.quant == "none"


def _tiny_dino_only(monkeypatch):
    """Both packages' DINO loaders on tests/test_torch_features_cli.py's tiny
    seeded Dinov2Model, the HF load step returning it for DINO's repo only
    (the language model loads from its directory)."""
    import transformers
    from transformers import Dinov2Config, Dinov2Model

    from tests.test_torch_features_cli import DINO
    from uml_tpu.models import dino as jdino
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
    load = transformers.AutoModel.from_pretrained

    def from_pretrained(repo, *a, **kw):
        return hf if repo == "tiny/dinov2" else load(repo, *a, **kw)

    monkeypatch.setattr(transformers.AutoModel, "from_pretrained",
                        staticmethod(from_pretrained))
    return DINO


@pytest.mark.parametrize("family,quant", [("llama", "none"), ("llama", "int8"),
                                          ("gpt2", "none")])
def test_features_cli_language_model_caches_agree(tmp_path, monkeypatch, family,
                                                  quant):
    from uml_tpu.cli import features as jax_features
    from uml_tpu.cli import generate_fewshot as gf
    from uml_tpu.data.feature_cache import load_cache, text_outdir
    from uml_tpu_torch.cli import features as torch_features
    import uml_tpu.native
    import uml_tpu_torch.native

    monkeypatch.setattr(uml_tpu.native, "native_available", lambda: False)
    monkeypatch.setattr(uml_tpu_torch.native, "native_available", lambda: False)
    lm = str(tmp_path / f"tiny-{family}")
    SAVERS[family](lm)
    dino = _tiny_dino_only(monkeypatch)
    root = make_caltech_fixture(str(tmp_path / "data"))
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    caches = {}
    for name, cli in (("jax", jax_features), ("torch", torch_features)):
        fdir = str(tmp_path / f"features_{name}")
        args = cli.build_parser().parse_args([
            "--data_dir", root, "--indices_dir", f"{root}/indices",
            "--feature_dir", fdir, "--dataset", "caltech101", "--train-shot", "2",
            "--seed", "1", "--vision_model", dino, "--language_model", "gpt2",
            "--text-augmentation", "hand_crafted", "--quant", quant,
            "--batch-size", "8", "--num-workers", "1", "--mesh", "off"])
        # the flag's choices are hub names, which resolve to local files
        # through the HF cache; a directory stands in for such a name
        args.language_model = lm
        args.overwrite, args.force_rerun = False, False
        encoder = cli.main(args)
        if name == "torch":
            assert encoder.text_model.quant == ("int8_w" if quant == "int8"
                                                else "none")
        caches[name] = load_cache(text_outdir(fdir, lm, "caltech101",
                                              "hand_crafted"))
    got, want = caches["torch"], caches["jax"]
    np.testing.assert_allclose(got["features"], want["features"], atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["eot_indices"], want["eot_indices"])
    assert got["features"].shape[1] == 32
