"""HF language-model text encoders with the reference's pooling.

The port of uml_tpu/models/languagemodel.py (capability parity with the
reference's engine/models/languagemodel.py:10-62):

* the encoder family (BERT / RoBERTa / DeBERTa) -> the CLS row;
* the decoder family (LLaMA / Mistral / DeepSeek / GPT-2 / OPT / Bloom)
  -> the attention-masked mean of the last hidden state; pad token := eos;
* ``return_tokens``: the token-level states (a decoder's pads zeroed) and
  each row's token count; otherwise the indices are ``len(text)`` in
  characters (the reference's quirk, features.py:74-76).

The model: ``native``, the port's own encoder, for LLaMA / Mistral /
DeepSeek names, by the checkpoint's ``model_type``: LlamaEncoder
(models/llama.py) for ``llama`` / ``mistral``, DeepseekV2Encoder
(models/deepseek_v2.py) for ``deepseek_v2``; its load errors raise.
Otherwise HF's torch ``AutoModel`` (uml_tpu's ``flax`` and ``torch``
branches are both that model here).  Both run on the card
(core.device.default_device; ``UML_TORCH_DEVICE=cpu`` asks for the CPU),
in fp32, uml_tpu's default.
``quant="int8_w"`` (LlamaEncoder only) quantizes the weights on the
host before they move to the device.  ``mesh`` (a
``core.meshes.create_mesh`` mesh; native only, as uml_tpu's
languagemodel.py:110-114) shards the LlamaEncoder's projections over its
``model`` axis by ``LLAMA_TP_RULES`` (parallel/tensor_parallel.py) where
that axis is wider than 1 (a one-wide axis would only gather every weight
whole on every call); the outputs are those without it.  The
DeepseekV2Encoder raises on ``int8_w`` and on a ``model`` axis wider than
1, and runs unsharded under a one-wide one.

``transformers`` is imported only where a model or tokenizer is loaded,
and only from local files (``local_files_only``): nothing here reaches
the network.  Without ``transformers`` or without the files, the
constructor raises the load error, which the features CLI under
``--allow_random_init`` turns into hash-random text features, as uml_tpu
does.  ``TextModel.native`` builds the native encoder from a LlamaConfig
or a DeepseekV2Config and a state_dict with no ``transformers`` at all, and ``encode_ids``
encodes token ids that are already made (span ``uml.text.encode``).
"""

from __future__ import annotations

import numpy as np
import torch

from uml_tpu_torch.core.device import default_device
from uml_tpu_torch.utils.profiling import span

_ENCODER_KEYS = ("bert", "roberta", "deberta")
_DECODER_KEYS = ("llama", "mistral", "deepseek", "gpt2", "opt", "bloom")

MODEL_ALIASES = {
    "bloom0.56b": "bigscience/bloom-560m",
    "bloom1.1b": "bigscience/bloom-1b1",
    "bloom1.7b": "bigscience/bloom-1b7",
    "bloom3b": "bigscience/bloom-3b",
    "openllama3b": "openlm-research/open_llama_3b_v2",
    "openllama7b": "openlm-research/open_llama_7b",
    "openllama13b": "openlm-research/open_llama_13b",
    "mistral7b": "mistralai/Mistral-7B-v0.1",
    "deepseek-v2-lite": "deepseek-ai/DeepSeek-V2-Lite",
}


def model_family(model_name: str) -> str:
    name = model_name.lower()
    if any(k in name for k in _ENCODER_KEYS):
        return "encoder"
    if any(k in name for k in _DECODER_KEYS):
        return "decoder"
    raise ValueError(f"Unsupported model type: {model_name!r}")


def is_native(model_name: str) -> bool:
    """Names the port's own encoders run (``_load_native`` picks the
    encoder by the checkpoint's ``model_type``)."""
    name = model_name.lower()
    return any(k in name for k in ("llama", "mistral", "deepseek"))


class TextModel:
    """Tokenizer + model + pooling (uml_tpu's TextModel).

    ``backend`` is "native" for LLaMA / Mistral / DeepSeek names, else
    "torch" (HF's model); ``quant`` "none" or "int8_w" (LlamaEncoder only,
    as in uml_tpu); ``device`` defaults to the card; ``mesh``: the native
    model tensor-parallel over its ``model`` axis where that is wider
    than 1.
    """

    def __init__(self, model_name: str, quant: str = "none", device=None,
                 mesh=None):
        from transformers import AutoTokenizer

        self.model_name = MODEL_ALIASES.get(model_name, model_name)
        self.model_type = model_family(self.model_name)
        self.quant = quant
        self.mesh = mesh
        self.device = torch.device(device) if device is not None else default_device()
        self.tokenizer = AutoTokenizer.from_pretrained(self.model_name,
                                                       local_files_only=True)
        if self.model_type == "decoder" and self.tokenizer.pad_token is None:
            self.tokenizer.pad_token = self.tokenizer.eos_token
        if is_native(self.model_name):
            self._load_native()
            self.backend = "native"
            print(f"=> Native {type(self.model).__name__} for {self.model_name} on "
                  f"{self.device}" + (f" (TP over {dict(zip(mesh.mesh_dim_names, mesh.shape))})"
                                      if self._sharded() else ""))
        else:
            from transformers import AutoModel

            self.model = AutoModel.from_pretrained(
                self.model_name, local_files_only=True).to(self.device).eval()
            self.backend = "torch"

    @classmethod
    def native(cls, config, state_dict: dict, quant: str = "none",
               device=None, mesh=None) -> "TextModel":
        """The native encoder of ``config`` (a LlamaConfig or a
        DeepseekV2Config) over a float state_dict (the port's names,
        models/llama.py, models/deepseek_v2.py), with no tokenizer and no
        ``transformers``: ``encode_ids`` takes the token ids.  With
        ``int8_w`` the weights are quantized where they lie; with ``mesh``
        the model is tensor-parallel over its ``model`` axis where that is
        wider than 1."""
        from uml_tpu_torch.models.deepseek_v2 import DeepseekV2Config

        self = cls.__new__(cls)
        self.model_name = "deepseek_v2" if isinstance(config, DeepseekV2Config) else "llama"
        self.model_type = "decoder"
        self.quant = quant
        self.mesh = mesh
        self.device = torch.device(device) if device is not None else default_device()
        self.tokenizer = None
        self._set_native(config, state_dict)
        self.backend = "native"
        return self

    def _sharded(self) -> bool:
        from uml_tpu_torch.core.meshes import model_size

        return model_size(self.mesh) > 1

    def _check_deepseek(self) -> None:
        if self.quant != "none":
            raise NotImplementedError(
                f"TextModel: quant {self.quant!r} is not supported for DeepSeek-V2 "
                "(only LLaMA / Mistral take int8_w)")
        if self._sharded():
            raise NotImplementedError(
                "TextModel: DeepSeek-V2 runs on one device; the mesh's model axis is "
                f"{dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}")

    def _set_native(self, config, state_dict: dict) -> None:
        from uml_tpu_torch.models.deepseek_v2 import DeepseekV2Config, build_deepseek_v2
        from uml_tpu_torch.models.llama import build_llama, quantize_llama_params

        self.config = config
        if isinstance(config, DeepseekV2Config):
            self._check_deepseek()
            self.model = build_deepseek_v2(config, state_dict).to(self.device).eval()
            return
        if self.quant == "int8_w":
            state_dict = quantize_llama_params(state_dict)
        self.model = build_llama(config, state_dict, torch.float32,
                                 self.quant).to(self.device).eval()
        if self._sharded():
            from uml_tpu_torch.models.llama import LLAMA_TP_RULES
            from uml_tpu_torch.parallel import apply_tp_sharding

            apply_tp_sharding(self.model, self.mesh, rules=LLAMA_TP_RULES)

    def _load_native(self) -> None:
        """Local HF checkpoint -> the port's encoder of its ``model_type``:
        ported (and for int8_w quantized) on the host, then moved to the
        device."""
        from transformers import AutoConfig, AutoModel

        from uml_tpu_torch.models.deepseek_v2 import DeepseekV2Config, port_hf_deepseek_v2
        from uml_tpu_torch.models.llama import LlamaConfig, port_hf_llama

        hf_cfg = AutoConfig.from_pretrained(self.model_name, local_files_only=True)
        if hf_cfg.model_type == "deepseek_v2":
            cfg, port = DeepseekV2Config.from_hf(hf_cfg), port_hf_deepseek_v2
            self._check_deepseek()
        elif hf_cfg.model_type in ("llama", "mistral"):
            cfg, port = LlamaConfig.from_hf(hf_cfg), port_hf_llama
        else:
            raise NotImplementedError(f"TextModel: no native encoder for {self.model_name!r} "
                                      f"(model_type {hf_cfg.model_type!r})")
        hf = AutoModel.from_pretrained(self.model_name, local_files_only=True)
        state_dict = port(hf.state_dict(), cfg)
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
        with span("uml.text.encode"), torch.no_grad():
            ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
            mask = torch.as_tensor(attention_mask, dtype=torch.long, device=self.device)
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
