"""Affect-dataset ingestion (CMU-MOSI/MOSEI, MUStARD sarcasm, UR-FUNNY humor).

The port of uml_tpu/data/affect.py: host numpy, so the same code.

Capability parity with MultiBench/datasets/affect/get_data.py:
  * pickle schema {train,valid,test} x {vision,audio,text,labels,id}
  * drop_entry removes rows whose text sums to zero (:27-44)
  * audio -inf -> 0 (:182); optional dataset-level vision normalization
    (:185-191); leading-zero trim from the first nonzero text step (:207-220,
    aligned mode); optional per-sample z-norm (:222-226)
  * label mapping: mosi/mosei sign -> {0,1}; sarcasm/humor -> -1/1 raw
    (binarized at probe time, train.py:19-29)
  * per-modality true-length tensors like collate `_process_1` (:418-444)
  * seeded shuffle (generator seed 42, :313-318)
  * robust_test=True builds noise-level test variants per modality

Fixed shapes: instead of ragged pad-to-batch-max collation, every split is
padded once to the split max length — one static shape per split, so
every train step of a split sees the same shapes.
"""

from __future__ import annotations

import pickle

import numpy as np

DATASET_CONFIG = {
    # parity: MultiBench/main.py:66-105 hard-wired batch size and [x, y] dims
    "mosi": {"batch_size": 32, "indims": [20, 300], "file": "mosi_data.pkl",
             "vision_norm": False},
    "mosei": {"batch_size": 32, "indims": [35, 300],
              "file": "mosei_senti_data.pkl", "vision_norm": False},
    "sarcasm": {"batch_size": 128, "indims": [371, 300], "file": "sarcasm.pkl",
                "vision_norm": True},
    "humor": {"batch_size": 128, "indims": [371, 300], "file": "humor.pkl",
              "vision_norm": False},
    "mimic": {"batch_size": 128, "indims": [5, 12], "file": "im.pk",
              "vision_norm": False},
}

MODALITIES = ("vision", "audio", "text")


def drop_entry(dataset: dict) -> dict:
    """Remove rows with all-zero text (get_data.py:27-44)."""
    drop = [i for i, t in enumerate(dataset["text"]) if t.sum() == 0]
    return {k: np.delete(np.asarray(v), drop, 0) for k, v in dataset.items()}


def mosi_label(y):
    return (np.asarray(y) >= 0).astype(np.int64)


def sarcasm_label(y):
    y = np.asarray(y).copy()
    y[y == -1] = 0
    return y.astype(np.int64)


def map_labels(y, ds_name):
    if ds_name in ("mosi", "mosei"):
        return mosi_label(y).reshape(-1)
    if ds_name in ("sarcasm", "humor"):
        return sarcasm_label(y).reshape(-1)
    if ds_name == "mimic":
        # labels are already integer classes (mortality/icd9); the
        # reference raises NotImplementedError here (train.py:42-47),
        # leaving its mimic eval path dead — we support it
        return np.asarray(y).reshape(-1).astype(np.int64)
    raise NotImplementedError(f"Dataset {ds_name} not implemented yet")


class AffectSplit:
    """One split as fixed-shape padded arrays + true lengths.

    Attributes: vision/audio/text [N, T_max, D_mod] float32,
    lengths {modality: [N] int32}, labels [N, ...] raw (unmapped).
    """

    def __init__(self, data: dict, data_type="mosi", vision_norm=False,
                 z_norm=False):
        data = dict(data)
        data["audio"] = np.asarray(data["audio"], np.float32)
        data["audio"][data["audio"] == -np.inf] = 0.0
        if vision_norm:
            v = np.asarray(data["vision"], np.float64)
            flat = v.reshape(-1, v.shape[-1])
            data["vision"] = ((v - flat.mean(0)) / flat.std(0)).astype(np.float32)

        n = len(data["text"])
        trimmed = {m: [] for m in MODALITIES}
        lengths = []
        for i in range(n):
            text = np.asarray(data["text"][i])
            nz = np.nonzero(text.reshape(len(text), -1).any(axis=1))[0]
            start = int(nz[0]) if len(nz) else 0
            for m in MODALITIES:
                seq = np.asarray(data[m][i], np.float32)[start:]
                if z_norm:
                    seq = np.nan_to_num(
                        (seq - seq.mean(0, keepdims=True)) / seq.std(0, keepdims=True))
                trimmed[m].append(seq)
            lengths.append(len(trimmed["text"][-1]))

        t_max = max(lengths)
        self.lengths = {m: np.asarray([len(s) for s in trimmed[m]], np.int32)
                        for m in MODALITIES}
        self.arrays = {}
        for m in MODALITIES:
            dim = trimmed[m][0].shape[-1] if trimmed[m][0].ndim > 1 else 1
            out = np.zeros((n, t_max, dim), np.float32)
            for i, seq in enumerate(trimmed[m]):
                seq = seq.reshape(len(seq), -1)
                out[i, : len(seq)] = seq
            self.arrays[m] = out
        self.labels = np.asarray(data["labels"])
        if data_type in ("humor", "sarcasm"):
            # regression-task label squash (get_data.py:239-244)
            self.labels = np.where(np.asarray(self.labels) < 1, -1, 1)
        self.data_type = data_type

    def __len__(self):
        return len(self.labels)

    @property
    def vision(self):
        return self.arrays["vision"]

    @property
    def audio(self):
        return self.arrays["audio"]

    @property
    def text(self):
        return self.arrays["text"]


def load_affect(filepath: str, data_type="mosi", vision_norm=False,
                z_norm=False) -> dict[str, AffectSplit]:
    with open(filepath, "rb") as f:
        alldata = pickle.load(f)
    return {
        split: AffectSplit(drop_entry(alldata[split]), data_type,
                           vision_norm, z_norm)
        for split in ("train", "valid", "test")
    }


class AffectBatchStream:
    """Seeded shuffled epoch batches over an AffectSplit.

    One stream per "unpaired" modality source: the reference builds two
    independently-shuffled DataLoaders and zips them (main.py:70-71).
    Yields dicts {modality -> [B, T, D]}, {modality -> lengths [B]},
    labels [B]; partial final batch is dropped by zip-semantics upstream.
    """

    def __init__(self, split: AffectSplit, batch_size: int, seed: int = 42,
                 shuffle: bool = True, drop_last: bool | None = None):
        self.split = split
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        # train streams drop the partial batch (zip semantics make it moot);
        # eval streams keep it (DataLoader drop_last=False parity)
        self.drop_last = shuffle if drop_last is None else drop_last

    def num_batches(self):
        n = len(self.split)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def epoch(self):
        n = len(self.split)
        idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(self.num_batches()):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield (
                {m: self.split.arrays[m][sel] for m in MODALITIES},
                {m: self.split.lengths[m][sel] for m in MODALITIES},
                self.split.labels[sel],
            )


def make_robust_tests(split: AffectSplit, levels=10, rng_seed=0):
    """Noise-level test variants per modality.

    Parity with get_data.py:349-410: per-modality variants use
    noise_level = level/10 with rand_drop=False; the combined-timeseries
    variant uses level/(10*3).  (The GloVe noisy-text path needs
    downloadable vectors — see data/text_embed.reembed_noisy_text.)
    """
    from uml_tpu_torch.data.robustness import add_timeseries_noise

    rng = np.random.RandomState(rng_seed)
    out = {"vision": [], "audio": [], "timeseries": []}
    for level in range(levels):
        vision = np.stack(add_timeseries_noise(
            [list(split.vision)], level / 10, rand_drop=False,
            rng=rng)[0]).astype(np.float32)
        audio = np.stack(add_timeseries_noise(
            [list(split.audio)], level / 10, rand_drop=False,
            rng=rng)[0]).astype(np.float32)
        both = add_timeseries_noise(
            [list(split.vision), list(split.audio), list(split.text)],
            level / (10 * 3), rand_drop=False, rng=rng)
        out["vision"].append(vision)
        out["audio"].append(audio)
        out["timeseries"].append([np.stack(x).astype(np.float32) for x in both])
    return out
