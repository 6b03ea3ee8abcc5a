"""Offline affect preprocessing: CMU hdf5 -> MultiBench pickle.

The port of uml_tpu/data/preprocess_affect.py: host code, so the same.

Port of the reference's offline tools with the embedder made pluggable:
  * ``get_rawtext``          — affect get_raw_data.py:69-100 (hdf5 word
    streams, 'sp' pause tokens dropped)
  * ``embed_left_padded``    — get_raw_data.py:151-184 (word vectors,
    LEFT zero-padding to ``paddings``, truncation past it)
  * ``build_affect_pickle``  — get_raw_data.py:187-258 (fold routing via
    video-id prefixes, lpad of the audio/visual streams, the
    {train,valid,test} x {vision,audio,text,labels,id} schema)
  * ``get_bert_features``    — get_bert_embedding.py:17-54 semantics live
    in uml_tpu_torch.data.text_embed.embed_texts (contextual vs
    input-embedding mode through models/languagemodel.py)

Zero-egress: the word embedder defaults to $UML_GLOVE_PATH vectors or the
deterministic hash-vocabulary fallback (data/text_embed.py); the reference
hardwires a torchtext GloVe download.
"""

from __future__ import annotations

import pickle

import numpy as np


def lpad(arr: np.ndarray, seq_len: int) -> np.ndarray:
    """Left-pad with zeros to seq_len, keeping the LAST seq_len steps
    (get_raw_data.py:15-27)."""
    arr = np.asarray(arr)
    padded = np.concatenate(
        [np.zeros([seq_len] + list(arr.shape[1:]), arr.dtype), arr], axis=0)
    return padded[-seq_len:, ...]


def detect_entry_fold(entry: str, folds) -> int | None:
    """Video-id prefix -> fold index (get_raw_data.py:30-44)."""
    entry_id = entry.split("[")[0]
    for i, fold in enumerate(folds):
        if entry_id in fold:
            return i
    return None


def get_rawtext(path: str, vids) -> tuple[list, list]:
    """hdf5 word streams -> sentences; 'sp' pause tokens dropped
    (get_raw_data.py:69-100)."""
    import h5py

    text_data, new_vids = [], []
    with h5py.File(path, "r") as f:
        for vid in vids:
            try:
                words = [w[0].decode("utf-8") for w in
                         f["words"][vid]["features"] if w[0] != b"sp"]
            except KeyError:
                print("missing", vid)
                continue
            text_data.append(" ".join(words))
            new_vids.append(vid)
    return text_data, new_vids


def embed_left_padded(text_data, embedder=None, paddings: int = 50,
                      dim: int = 300) -> np.ndarray:
    """Word-vector embeddings, LEFT zero-padded to ``paddings`` steps and
    truncated past it (get_raw_data.py:151-184).

    ``embedder`` needs ``.vectors`` (word -> vec) and ``.dim`` — the
    WordVectorEmbedder/HashVocabEmbedder from data/text_embed.py qualify;
    default resolves via $UML_GLOVE_PATH or the hash-vocab fallback.
    """
    from uml_tpu_torch.data.text_embed import default_text_embedder

    if embedder is None:
        embedder = default_text_embedder(text_data, dim=dim)
    d = embedder.dim
    out = np.zeros((len(text_data), paddings, d), np.float32)
    for i, sentence in enumerate(text_data):
        words = sentence.split()[:paddings]
        vecs = [embedder.vectors.get(w, np.zeros(d, np.float32))
                for w in words]
        if vecs:
            out[i, paddings - len(vecs):] = np.stack(vecs)
    return out


def build_affect_pickle(
    hdf5_path: str,
    out_path: str,
    folds,                      # [train_ids, valid_ids, test_ids]
    *,
    audio_key: str = "COVAREP",
    video_key: str = "FACET_4.2",
    label_key: str = "Opinion Segment Labels",
    seq_len: int = 50,
    embedder=None,
) -> dict:
    """hdf5 computational sequences -> the MultiBench pickle schema
    (get_raw_data.py:187-258 + __main__)."""
    import h5py

    with h5py.File(hdf5_path, "r") as f:
        vids = list(f["words"].keys())
    raw_text, vids = get_rawtext(hdf5_path, vids)
    text_emb = embed_left_padded(raw_text, embedder, paddings=seq_len)

    csds = [audio_key, video_key, label_key]
    data = [{csd: [] for csd in csds} | {"words": [], "id": []}
            for _ in range(3)]
    with h5py.File(hdf5_path, "r") as f:
        for i, key in enumerate(vids):
            fold = detect_entry_fold(key, folds)
            if fold is None:
                print(f"Key {key} doesn't belong to any fold ...")
                continue
            for csd in csds:
                arr = np.asarray(f[csd][key]["features"])
                data[fold][csd].append(
                    arr if csd == label_key else lpad(arr, seq_len))
            data[fold]["words"].append(text_emb[i])
            data[fold]["id"].append(key)

    all_data = {}
    for i, fold in enumerate(("train", "valid", "test")):
        all_data[fold] = {
            "vision": np.asarray(data[i][video_key], np.float32),
            "audio": np.asarray(data[i][audio_key], np.float32),
            "text": np.stack(data[i]["words"]).astype(np.float32),
            "labels": np.asarray(data[i][label_key], np.float32),
            "id": data[i]["id"],
        }
    with open(out_path, "wb") as f:
        pickle.dump(all_data, f)
    return all_data
