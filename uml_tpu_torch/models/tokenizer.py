"""CLIP BPE tokenizer.

Reimplements OpenAI CLIP's byte-level BPE (behavioral parity with
engine/clip/simple_tokenizer.py + clip.py:185-221 ``tokenize``) against the
public ``bpe_simple_vocab_16e6.txt.gz`` merge table (the data file vendored in
``uml_tpu/assets``, read by path).

Output is numpy int32 [N, 77] with SOT/EOT framing and zero padding; the
EOT index per row is ``argmax`` of the row (EOT is the largest id), the
contract the text tower's pooling relies on (model.py:358).

``ftfy`` is optional: when it is not installed, text cleanup falls back to
html-unescape + whitespace collapse, which is the identity on the ASCII
prompt templates the reference uses.
"""

from __future__ import annotations

import functools
import gzip
import html
import os

import numpy as np

from uml_tpu_torch import ASSET_DIR

try:
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re

try:
    from ftfy import fix_text as _fix_text
except ImportError:  # pragma: no cover - ftfy is optional
    def _fix_text(text: str) -> str:
        return text

CONTEXT_LENGTH = 77
_VOCAB_PATH = os.path.join(ASSET_DIR,
                           "bpe_simple_vocab_16e6.txt.gz")
_N_MERGES = 49152 - 256 - 2  # merge rows used from the table (48894)


@functools.lru_cache()
def byte_to_unicode() -> dict[int, str]:
    """GPT-2-style reversible byte<->unicode map (printables keep their
    codepoint; the rest are remapped above U+0100)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


class ClipTokenizer:
    def __init__(self, bpe_path: str = _VOCAB_PATH):
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        lines = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = [tuple(line.split()) for line in lines[1 : _N_MERGES + 1]]
        self.bpe_ranks = {pair: rank for rank, pair in enumerate(merges)}

        base = list(self.byte_encoder.values())
        vocab = base + [t + "</w>" for t in base] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

        self._cache: dict[str, tuple[str, ...]] = {}
        self._word_pattern = _re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            _re.IGNORECASE,
        )

    # -- BPE ---------------------------------------------------------------

    def _merge_word(self, token: str) -> tuple[str, ...]:
        """Apply ranked merges until none apply. The word starts as the
        byte-mapped characters with </w> fused onto the final one."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        while len(word) > 1:
            pairs = list(zip(word[:-1], word[1:]))
            ranks = [self.bpe_ranks.get(p, None) for p in pairs]
            best = min(
                (r for r in ranks if r is not None), default=None
            )
            if best is None:
                break
            first, second = pairs[ranks.index(best)]
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)

        self._cache[token] = word
        return word

    # -- public API ---------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        text = _fix_text(text)
        text = html.unescape(html.unescape(text))
        text = _re.sub(r"\s+", " ", text).strip().lower()
        ids: list[int] = []
        for token in self._word_pattern.findall(text):
            if token in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.encoder[token])
                continue
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._merge_word(mapped))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = False):
    """str-or-list -> int32 [N, context_length]; parity with clip.py:185-221."""
    if isinstance(texts, str):
        texts = [texts]
    tk = _default_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tk.sot_token] + tk.encode(text) + [tk.eot_token]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {texts[i]} is too long for context length {context_length}"
                )
            tokens = tokens[: context_length - 1] + [tk.eot_token]
        result[i, : len(tokens)] = tokens
    return result
