"""Host-side image batch loader: threaded PIL decode with prefetch.

The counterpart of uml_tpu.data.loader.ImageBatchLoader (the reference
uses torch DataLoader workers, features.py:152-161).  A thread pool decodes
JPEGs to uint8 224x224x3 (PIL's C decode releases the GIL) and batches are
assembled ahead of consumption with a bounded prefetch window; the CLIP
normalization is folded into the patch embedding on the device, so each
batch crosses the host->device link as uint8.

``RawImageStream`` is the full-finetune training stream: shuffled epochs
of flat uint8 batches, padded to a fixed batch with zero weights.

Only the PIL decode path is ported; the native libjpeg decoder of
uml_tpu.native and the spawn-process decode pool come later.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from uml_tpu_torch.data.transforms import load_uint8


def _decode_batch_items(batch_items, batch_idx, augmentation, size, seed):
    rng = np.random.default_rng((seed, batch_idx))
    imgs = np.empty((len(batch_items), *size, 3), dtype=np.uint8)
    for i, item in enumerate(batch_items):
        imgs[i] = load_uint8(item["impath"], augmentation, size, rng)
    labels = np.asarray([it["label"] for it in batch_items], dtype=np.int64)
    paths = [it["impath"] for it in batch_items]
    return imgs, labels, paths


class ImageBatchLoader:
    """Iterate item dicts ({'impath','label',...}) as uint8 batches.

    Yields (images_uint8 [B,H,W,3], labels int64 [B], paths list[str]).
    Deterministic order (no shuffle) like the reference's extraction loader;
    the final partial batch is yielded as-is (drop_last=False).  The
    augmentation RNG is seeded per (seed, batch index), as in uml_tpu, so
    both packages decode the same pixels.  ``start_batch`` begins at that
    batch index (resume: the RNG is seeded by the absolute index, so later
    batches are the same as in a full pass).
    """

    def __init__(self, items, augmentation="crop", batch_size=256,
                 num_workers=16, prefetch=4, seed=0, size=(224, 224),
                 start_batch=0):
        self.items = items
        self.augmentation = augmentation
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.size = size
        self.start_batch = start_batch

    def __len__(self):
        return (len(self.items) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        s0 = self.start_batch
        batches = [self.items[i:i + self.batch_size]
                   for i in range(0, len(self.items), self.batch_size)][s0:]
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
            futures = []

            def submit(idx):
                futures.append(pool.submit(
                    _decode_batch_items, batches[idx], s0 + idx,
                    self.augmentation, self.size, self.seed))

            for idx in range(min(self.prefetch, len(batches))):
                submit(idx)
            for idx in range(len(batches)):
                if idx + self.prefetch < len(batches):
                    submit(idx + self.prefetch)
                yield futures[idx].result()


class RawImageStream:
    """Infinite shuffled raw-image batches for full backbone finetuning
    (uml_tpu/data/loader.py:172-230).

    Each epoch draws a fresh permutation from ``np.random.default_rng(seed)``
    and decodes with augmentation seeded per (epoch, batch index): the same
    stream as uml_tpu's.  Yields (uint8 flat [B, H*W*3], labels int64 [B],
    weights fp32 [B]); a partial final batch is padded to ``batch_size``
    with zero weights.
    """

    def __init__(self, items, augmentation, batch_size, seed=0,
                 num_workers=8, size=(224, 224)):
        self.items = list(items)
        self.augmentation = augmentation
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.size = size

    def __iter__(self):
        return self._iterate(0)

    def skip(self, n_batches: int):
        """An iterator aligned with batch ``n_batches`` without decoding
        the skipped images (one permutation draw per skipped epoch keeps
        the RNG stream the same as a replay)."""
        return self._iterate(n_batches)

    def _iterate(self, skip_batches: int):
        epoch = 0
        bpe = (len(self.items) + self.batch_size - 1) // self.batch_size
        while skip_batches >= bpe:
            self.rng.permutation(len(self.items))
            epoch += 1
            skip_batches -= bpe
        while True:
            order = self.rng.permutation(len(self.items))
            shuffled = [self.items[i] for i in order]
            loader = ImageBatchLoader(
                shuffled, self.augmentation, self.batch_size,
                num_workers=self.num_workers, seed=epoch, size=self.size,
                start_batch=skip_batches)
            skip_batches = 0
            for imgs, labels, _ in loader:
                n = len(labels)
                imgs = imgs.reshape(n, -1)
                weights = np.ones(self.batch_size, np.float32)
                if n < self.batch_size:
                    pad = self.batch_size - n
                    imgs = np.concatenate(
                        [imgs, np.zeros((pad, imgs.shape[1]), np.uint8)])
                    labels = np.concatenate([labels, np.zeros(pad, np.int64)])
                    weights[n:] = 0.0
                yield imgs, labels, weights
            epoch += 1
