"""Host-side image batch loader: threaded PIL decode with prefetch.

The counterpart of uml_tpu.data.loader.ImageBatchLoader (the reference
uses torch DataLoader workers, features.py:152-161).  A thread pool decodes
JPEGs to uint8 224x224x3 (PIL's C decode releases the GIL) and batches are
assembled ahead of consumption with a bounded prefetch window; the CLIP
normalization is folded into the patch embedding on the device, so each
batch crosses the host->device link as uint8.

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
    both packages decode the same pixels.
    """

    def __init__(self, items, augmentation="crop", batch_size=256,
                 num_workers=16, prefetch=4, seed=0, size=(224, 224)):
        self.items = items
        self.augmentation = augmentation
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.size = size

    def __len__(self):
        return (len(self.items) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        batches = [self.items[i:i + self.batch_size]
                   for i in range(0, len(self.items), self.batch_size)]
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
            futures = []

            def submit(idx):
                futures.append(pool.submit(
                    _decode_batch_items, batches[idx], idx,
                    self.augmentation, self.size, self.seed))

            for idx in range(min(self.prefetch, len(batches))):
                submit(idx)
            for idx in range(len(batches)):
                if idx + self.prefetch < len(batches):
                    submit(idx + self.prefetch)
                yield futures[idx].result()
