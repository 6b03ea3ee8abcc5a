"""The HF language-model text encoders of ``--language_model``: not ported.

uml_tpu/models/languagemodel.py wraps HF BERT / RoBERTa (CLS pooling) and
LLaMA-family decoders (masked-mean pooling, its own LlamaEncoder); its
port is still to come (ROADMAP.md, queue 1).  What this module keeps is
how the reference behaves on a machine where the model cannot run:

* where the model's files are in the local HF cache (``transformers``
  importable and a ``local_files_only`` load of its tokenizer succeeds),
  uml_tpu would encode with it, and the port refuses: ``TextModel`` raises
  SystemExit, which ``--allow_random_init`` does not turn into random
  features;
* otherwise it raises the load error uml_tpu's TextModel raises there
  (an ImportError without ``transformers``, an OSError without the
  files; ValueError for a model family it does not know), and the
  features CLI under ``--allow_random_init`` then takes hash-random
  text features, as uml_tpu does.

Nothing here reaches the network: the tokenizer is looked up in the local
cache only.
"""

from __future__ import annotations

_ENCODER_KEYS = ("bert", "roberta", "deberta")
_DECODER_KEYS = ("llama", "mistral", "gpt2", "opt", "bloom")

MODEL_ALIASES = {
    "bloom0.56b": "bigscience/bloom-560m",
    "bloom1.1b": "bigscience/bloom-1b1",
    "bloom1.7b": "bigscience/bloom-1b7",
    "bloom3b": "bigscience/bloom-3b",
    "openllama3b": "openlm-research/open_llama_3b_v2",
    "openllama7b": "openlm-research/open_llama_7b",
    "openllama13b": "openlm-research/open_llama_13b",
    "mistral7b": "mistralai/Mistral-7B-v0.1",
}


def model_family(model_name: str) -> str:
    name = model_name.lower()
    if any(k in name for k in _ENCODER_KEYS):
        return "encoder"
    if any(k in name for k in _DECODER_KEYS):
        return "decoder"
    raise ValueError(f"Unsupported model type: {model_name!r}")


class TextModel:
    """Raises at construction: SystemExit where the model's files are
    local (the port cannot run what uml_tpu would), else the load error."""

    def __init__(self, model_name: str):
        self.model_name = MODEL_ALIASES.get(model_name, model_name)
        self.model_type = model_family(self.model_name)
        from transformers import AutoTokenizer

        AutoTokenizer.from_pretrained(self.model_name, local_files_only=True)
        raise SystemExit(
            f"--language_model {model_name}: its files are in the local HF "
            "cache, and the HF language-model text encoders are not ported to "
            "uml_tpu_torch yet (ROADMAP.md, queue 1)")


def refuse_if_local(model_name: str) -> None:
    """SystemExit where the model's files are local; a load error is left
    for the encoder's construction, where uml_tpu raises it."""
    try:
        TextModel(model_name)
    except Exception:
        pass
