"""Offline text (re-)embedding for affect datasets.

The port of uml_tpu/data/text_embed.py.  Capability parity with
MultiBench/datasets/affect/get_bert_embedding.py and the GloVe
re-embedding inside the robust_test path (get_data.py:332-347): turn raw
sentences into fixed-length [N, T, D] word-embedding arrays that slot into
the affect pickle schema's ``text`` modality.

``embed_texts`` uses any HF model through the port's
:class:`uml_tpu_torch.models.languagemodel.TextModel` (on the card by
default; ``UML_TORCH_DEVICE=cpu`` asks for the CPU), from local files only:
  * contextual=True  -> last hidden state per token (BERT contextual mode)
  * contextual=False -> input embedding table lookups (word-embedding mode,
    the reference's default)

``HashVocabEmbedder``, ``WordVectorEmbedder`` and ``default_text_embedder``
are host numpy, the same code as uml_tpu's.  The typical use with the
robustness suite:

    from uml_tpu_torch.data.robustness import add_text_noise
    noisy = add_text_noise(raw_sentences, level / 10)
    arr = embed_texts(noisy, model_name="bert-base-uncased", max_len=50)
"""

from __future__ import annotations

import numpy as np


def embed_texts(texts, model_name="bert-base-uncased", contextual=False,
                batch_size=256, max_len=None) -> np.ndarray:
    """list[str] -> float32 [N, max_len, hidden]."""
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
    if max_len is None:
        max_len = max(
            len([w for w in s.split() if w]) for s in texts
        )

    if contextual:
        from uml_tpu_torch.models.languagemodel import TextModel

        tm = TextModel(model_name)
        out = []
        for i in range(0, len(texts), batch_size):
            hidden, _ = tm.encode(texts[i : i + batch_size], return_tokens=True)
            t = hidden.shape[1]
            if t < max_len:
                hidden = np.pad(hidden, ((0, 0), (0, max_len - t), (0, 0)))
            out.append(hidden[:, :max_len].astype(np.float32))
        return np.concatenate(out)

    # word-embedding mode: raw input-embedding lookups (no transformer pass)
    from transformers import AutoModel

    model = AutoModel.from_pretrained(model_name, local_files_only=True)
    table = model.get_input_embeddings().weight.detach().numpy()
    out = np.zeros((len(texts), max_len, table.shape[1]), np.float32)
    for i in range(0, len(texts), batch_size):
        batch = tokenizer(texts[i : i + batch_size], padding="max_length",
                          truncation=True, max_length=max_len,
                          return_tensors="np")
        ids = np.asarray(batch["input_ids"])
        mask = np.asarray(batch["attention_mask"])[..., None]
        out[i : i + len(ids)] = table[ids] * mask
    return out


def load_word_vectors(path: str) -> dict:
    """Local GloVe-format text file: 'word v1 v2 ...' per line."""
    vecs = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 3:
                continue
            vecs[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
    return vecs


class WordVectorEmbedder:
    """Static word-vector lookup with torchtext's GloVe semantics
    (reference robust_test path, affect get_data.py:122-155):
    ``get_vecs_by_tokens(tokens, lower_case_backup=True)`` — a missing
    token falls back to its lower-cased form, and a still-missing token
    embeds to zeros (OOV->zeros).  Layout difference vs the reference's
    ``_glove_embeddings``: sequences are truncated to the first
    ``max_len`` words exactly like the reference, but padding goes at
    the END (the reference zero-pads at the FRONT, then its
    Affectdataset trims leading zeros again — our consumers carry
    explicit length tensors instead, so the word vectors and their
    order are identical; only the dead zero rows sit on the other
    side).  Pinned by tests/test_text_embed.py's reference-replica A/B."""

    def __init__(self, vectors: dict):
        self.vectors = vectors
        self.dim = len(next(iter(vectors.values())))

    def lookup(self, w) -> np.ndarray | None:
        vec = self.vectors.get(w)
        if vec is None:
            vec = self.vectors.get(w.lower())
        return vec

    def __call__(self, texts, max_len: int) -> np.ndarray:
        out = np.zeros((len(texts), max_len, self.dim), np.float32)
        for i, s in enumerate(texts):
            for j, w in enumerate(s.split()[:max_len]):
                vec = self.lookup(w)
                if vec is not None:
                    out[i, j] = vec
        return out


class HashVocabEmbedder:
    """Deterministic zero-egress stand-in for GloVe: every word of the
    CLEAN vocabulary gets a fixed unit-variance vector seeded from
    blake2(word); out-of-vocabulary words (typo-corrupted by the noise
    model) embed to zeros, exactly like GloVe OOV lookups — so the
    degradation curves have the reference's shape without any downloaded
    vector file."""

    def __init__(self, clean_texts, dim: int = 300):
        import hashlib

        from uml_tpu_torch.data.robustness import _normalize_text

        self.dim = dim
        self.vectors = {}
        for s in clean_texts:
            # vocabulary through the SAME normalization the noise model
            # applies (lowercase, punctuation split, digit folding) —
            # raw cased/punctuated corpora would otherwise miss their
            # own level-0 (uncorrupted) words and read as degraded
            for w in s.split() + _normalize_text(s):
                if w in self.vectors:
                    continue
                h = hashlib.blake2b(w.encode("utf-8"), digest_size=8)
                rng = np.random.default_rng(
                    int.from_bytes(h.digest(), "little"))
                self.vectors[w] = rng.standard_normal(dim).astype(np.float32)

    def __call__(self, texts, max_len: int) -> np.ndarray:
        out = np.zeros((len(texts), max_len, self.dim), np.float32)
        for i, s in enumerate(texts):
            for j, w in enumerate(s.split()[:max_len]):
                vec = self.vectors.get(w)
                if vec is not None:
                    out[i, j] = vec
        return out


def default_text_embedder(clean_texts, dim: int = 300):
    """$UML_GLOVE_PATH-backed GloVe when available, else the deterministic
    hash-vocabulary fallback (no egress required either way)."""
    import os

    path = os.environ.get("UML_GLOVE_PATH", "")
    if path and os.path.exists(path):
        return WordVectorEmbedder(load_word_vectors(path))
    return HashVocabEmbedder(clean_texts, dim=dim)


def reembed_noisy_text(raw_sentences, noise_levels=10, model_name=None,
                       embed_fn=None, max_len=50, seed=0):
    """Noisy-text robustness arrays: for each level l/10, typo-corrupt the
    raw sentences and re-embed them (affect get_data.py:332-347 with the
    embedder pluggable instead of hardwired GloVe)."""
    from uml_tpu_torch.data.robustness import add_text_noise

    if embed_fn is None:
        embed_fn = lambda ts: embed_texts(ts, model_name or "bert-base-uncased",
                                          max_len=max_len)
    rng = np.random.RandomState(seed)
    out = []
    for level in range(noise_levels):
        noisy = add_text_noise(raw_sentences, level / 10, rng=rng)
        out.append(embed_fn(noisy))
    return out
