"""HF language-model text encoders with the reference's pooling.

The port of uml_tpu/models/languagemodel.py (capability parity with the
reference's engine/models/languagemodel.py:10-62):

* the encoder family (BERT / RoBERTa / DeBERTa) -> the CLS row;
* the decoder family (LLaMA / Mistral / GPT-2 / OPT / Bloom) -> the
  attention-masked mean of the last hidden state; pad token := eos;
* ``return_tokens``: the token-level states (a decoder's pads zeroed) and
  each row's token count; otherwise the indices are ``len(text)`` in
  characters (the reference's quirk, features.py:74-76).

The model: ``native``, the port's LlamaEncoder (models/llama.py), for
LLaMA / Mistral names, and its load errors raise; otherwise HF's torch
``AutoModel`` (uml_tpu's ``flax`` and ``torch`` branches are both that
model here).  Both run on the card (core.device.default_device;
``UML_TORCH_DEVICE=cpu`` asks for the CPU), in fp32, uml_tpu's default.
``quant="int8_w"`` (native only) quantizes the weights on the host
before they move to the device.

``transformers`` is imported only where a model or tokenizer is loaded,
and only from local files (``local_files_only``): nothing here reaches
the network.  Without ``transformers`` or without the files, the
constructor raises the load error, which the features CLI under
``--allow_random_init`` turns into hash-random text features, as uml_tpu
does.  ``TextModel.native`` builds the native encoder from a LlamaConfig
and a state_dict with no ``transformers`` at all, and ``encode_ids``
encodes token ids that are already made.
"""

from __future__ import annotations

import numpy as np
import torch

from uml_tpu_torch.core.device import default_device

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


def is_llama_family(model_name: str) -> bool:
    name = model_name.lower()
    return any(k in name for k in ("llama", "mistral"))


class TextModel:
    """Tokenizer + model + pooling (uml_tpu's TextModel).

    ``backend`` is "native" for LLaMA / Mistral names, else "torch" (HF's
    model); ``quant`` "none" or "int8_w" (native only, as in uml_tpu);
    ``device`` defaults to the card.
    """

    def __init__(self, model_name: str, quant: str = "none", device=None):
        from transformers import AutoTokenizer

        self.model_name = MODEL_ALIASES.get(model_name, model_name)
        self.model_type = model_family(self.model_name)
        self.quant = quant
        self.device = torch.device(device) if device is not None else default_device()
        self.tokenizer = AutoTokenizer.from_pretrained(self.model_name,
                                                       local_files_only=True)
        if self.model_type == "decoder" and self.tokenizer.pad_token is None:
            self.tokenizer.pad_token = self.tokenizer.eos_token
        if is_llama_family(self.model_name):
            self._load_native()
            self.backend = "native"
            print(f"=> Native LlamaEncoder for {self.model_name} on {self.device}")
        else:
            from transformers import AutoModel

            self.model = AutoModel.from_pretrained(
                self.model_name, local_files_only=True).to(self.device).eval()
            self.backend = "torch"

    @classmethod
    def native(cls, config, state_dict: dict, quant: str = "none",
               device=None) -> "TextModel":
        """The native LlamaEncoder of ``config`` over a float state_dict
        (the port's names, models/llama.py), with no tokenizer and no
        ``transformers``: ``encode_ids`` takes the token ids.  With
        ``int8_w`` the weights are quantized where they lie."""
        self = cls.__new__(cls)
        self.model_name = "llama"
        self.model_type = "decoder"
        self.quant = quant
        self.device = torch.device(device) if device is not None else default_device()
        self.tokenizer = None
        self._set_native(config, state_dict)
        self.backend = "native"
        return self

    def _set_native(self, config, state_dict: dict) -> None:
        from uml_tpu_torch.models.llama import build_llama, quantize_llama_params

        if self.quant == "int8_w":
            state_dict = quantize_llama_params(state_dict)
        self.config = config
        self.model = build_llama(config, state_dict, torch.float32,
                                 self.quant).to(self.device).eval()

    def _load_native(self) -> None:
        """Local HF checkpoint -> the port's LlamaEncoder: ported (and
        for int8_w quantized) on the host, then moved to the device."""
        from transformers import AutoConfig, AutoModel

        from uml_tpu_torch.models.llama import LlamaConfig, port_hf_llama

        cfg = LlamaConfig.from_hf(AutoConfig.from_pretrained(
            self.model_name, local_files_only=True))
        hf = AutoModel.from_pretrained(self.model_name, local_files_only=True)
        state_dict = port_hf_llama(hf.state_dict(), cfg)
        del hf
        self._set_native(cfg, state_dict)

    @property
    def hidden_size(self) -> int:
        if self.backend == "native":
            return self.config.hidden_size
        return self.model.config.hidden_size

    def encode_ids(self, input_ids, attention_mask, return_tokens: bool = False):
        """Token ids and attention mask [B, T] (numpy or tensors) -> the
        pooled features [B, D] fp32 on the device (uml_tpu's pooling,
        languagemodel.py:196-217), or with ``return_tokens`` the states
        [B, T, D] (a decoder's pads zeroed)."""
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(attention_mask, dtype=torch.long, device=self.device)
        with torch.no_grad():
            if self.backend == "native":
                hidden = self.model(ids, mask)
            else:
                hidden = self.model(input_ids=ids, attention_mask=mask).last_hidden_state
            hidden = hidden.float()
            if self.model_type == "encoder":
                return hidden if return_tokens else hidden[:, 0, :]
            m = mask[..., None].float()
            if return_tokens:
                return hidden * m
            return (hidden * m).sum(1) / m.sum(1)

    def encode(self, texts: list[str], return_tokens: bool = False):
        """texts -> (features, indices) as numpy: indices are the token
        counts with ``return_tokens``, else ``len(text)`` in characters."""
        batch = self.tokenizer(texts, padding=True, truncation=True,
                               return_tensors="np")
        mask = np.asarray(batch["attention_mask"])
        out = self.encode_ids(batch["input_ids"], mask, return_tokens)
        if return_tokens:
            return out.cpu().numpy(), mask.sum(-1).astype(np.int64)
        return out.cpu().numpy(), np.asarray([len(t) for t in texts])
