"""Host-side image batch loader: threaded or spawn-process decode with
prefetch.

The counterpart of uml_tpu.data.loader (the reference uses torch
DataLoader workers, features.py:152-161).  A worker pool decodes JPEGs to
uint8 224x224x3 and batches are assembled ahead of consumption with a
bounded prefetch window; the CLIP normalization runs on the device, so
each batch crosses the host->device link as uint8.

Decoders, as in uml_tpu: for the deterministic ``crop`` pipeline at a
square size, the native libjpeg decoder of uml_tpu_torch.native (IDCT
scaling), with a per-image PIL fallback for a non-JPEG or corrupt file;
PIL (data/transforms.py::load_uint8) for every other augmentation, and
wherever g++ or libjpeg is missing.  The two decoders differ by ~2/255 on
average, so ``decoder`` in the feature caches says which one ran.

``worker_kind="process"`` decodes in spawned processes instead of threads
(the GIL serializes the per-image Python around the decoders): a
SpawnPool, whose workers each answer on a pipe of their own, so a worker
that dies at any point raises BrokenProcessPool in the waiting iterator
instead of hanging it.  The pools persist across loaders, keyed by worker
count, and a pool with a dead worker is rebuilt at the next iterator.
Spawn, never fork: the parent holds CUDA and threads.  A worker imports
this module, numpy, PIL and the native decoder, never torch.  The default
here stays "thread"; cli/features.py picks the kind.

``RawImageStream`` is the full-finetune training stream: shuffled epochs
of flat uint8 batches, padded to a fixed batch with zero weights.
"""

from __future__ import annotations

import itertools
import multiprocessing
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool

import numpy as np

from uml_tpu_torch.core.prng import epoch_perm, host_rng
from uml_tpu_torch.data.transforms import load_uint8

_PROC_NATIVE = None  # the decoder of this worker process (None: not probed)
# persistent spawn pools keyed by worker count: a spawned worker pays the
# interpreter's start and its imports once, not inside every extraction
_PROC_POOLS = {}


def _serve(conn):
    """A spawned worker: run each task that arrives, send back its result
    or its exception, until the parent closes its end."""
    while True:
        try:
            task, fn, args = conn.recv()
        except EOFError:
            return
        try:
            out = (task, True, fn(*args))
        except Exception as e:  # re-raised in the parent
            out = (task, False, e)
        try:
            conn.send(out)
        except OSError:  # the parent closed its end
            return


class SpawnPool:
    """``n`` spawned workers, each on a pipe of its own.  Task k goes to
    worker k mod n and its result comes back on that worker's pipe, in
    order.  Only the worker holds its end, so a worker that dies, even
    halfway through sending a result, reads here as end of file: the wait
    raises BrokenProcessPool at once and the pool is ``broken``.  (A
    ProcessPoolExecutor shares one result pipe and a lock among its
    workers, and waits forever for the rest of a message cut off so.)"""

    def __init__(self, n):
        ctx = multiprocessing.get_context("spawn")
        self.procs, self.conns = [], []
        for _ in range(n):
            conn, child = ctx.Pipe()
            proc = ctx.Process(target=_serve, args=(child,), daemon=True)
            proc.start()
            child.close()  # the worker alone holds its end
            self.procs.append(proc)
            self.conns.append(conn)
        self.broken = False
        self._lock = threading.Lock()
        self._tasks = itertools.count()
        self._arrived = {}    # task -> (ok, value), read while waiting for another
        self._dropped = set()  # tasks whose results nobody will read

    def submit(self, fn, *args):
        """Send fn(*args) to the next worker -> the task number."""
        task = next(self._tasks)
        with self._lock:
            self._check()
            try:
                self.conns[task % len(self.conns)].send((task, fn, args))
            except OSError as e:
                self._break(e)
        return task

    def result(self, task):
        """Wait for a task's result; re-raise its exception."""
        conn = self.conns[task % len(self.conns)]
        with self._lock:
            while task not in self._arrived:
                self._check()
                try:
                    got, ok, value = conn.recv()
                except (EOFError, OSError) as e:
                    self._break(e)
                if got in self._dropped:
                    self._dropped.discard(got)
                else:
                    self._arrived[got] = (ok, value)
            ok, value = self._arrived.pop(task)
        if not ok:
            raise value
        return value

    def drop(self, tasks):
        """Discard the results of ``tasks`` when they arrive."""
        with self._lock:
            for task in tasks:
                if self._arrived.pop(task, None) is None:
                    self._dropped.add(task)

    def alive(self):
        return not self.broken and all(p.is_alive() for p in self.procs)

    def shutdown(self):
        for conn in self.conns:
            conn.close()  # a worker reads end of file and returns
        for proc in self.procs:
            proc.join(5)
            if proc.is_alive():
                proc.kill()
                proc.join()

    def _check(self):
        if self.broken:
            raise BrokenProcessPool("a decode worker died; the next "
                                    "iterator rebuilds the pool")

    def _break(self, cause):
        self.broken = True
        raise BrokenProcessPool("a decode worker died") from cause


def _proc_pool(n):
    """The spawn pool of ``n`` workers, rebuilt if a worker died."""
    pool = _PROC_POOLS.get(n)
    if pool is not None and not pool.alive():
        pool.shutdown()
        pool = None
    if pool is None:
        pool = _PROC_POOLS[n] = SpawnPool(n)
    return pool


def shutdown_proc_pools():
    """Tear down the persistent decode pools."""
    for pool in list(_PROC_POOLS.values()):
        pool.shutdown()
    _PROC_POOLS.clear()


def _decode_batch_items(batch_items, batch_idx, augmentation, size, seed,
                        use_native=False):
    """Decode one batch (module-level, so a process pool can pickle it).
    ``use_native``: the caller decodes natively, and so must this process
    (probed once per process): the native decoder first, PIL for what it
    cannot decode."""
    native_fn = None
    if use_native:
        global _PROC_NATIVE
        if _PROC_NATIVE is None:
            from uml_tpu_torch import native

            _PROC_NATIVE = (native.fast_decode_jpeg
                            if native.native_available() else False)
        if not _PROC_NATIVE:
            raise RuntimeError("the native decoder does not load in this "
                               "decode worker, but the loader decodes natively")
        native_fn = _PROC_NATIVE
    rng = np.random.default_rng((seed, batch_idx))
    imgs = np.empty((len(batch_items), *size, 3), dtype=np.uint8)
    for i, item in enumerate(batch_items):
        if native_fn is not None:
            try:
                imgs[i] = native_fn(item["impath"], size[0])
                continue
            except RuntimeError:
                pass  # non-JPEG or corrupt: PIL decodes it below
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
    batches are the same as in a full pass).  ``fast_decode`` allows the
    native decoder where it applies (``crop``, a square size);
    ``_native`` is its decode function where this process has it.
    ``shard=(rank, n)`` yields only the batches whose index is ``rank``
    modulo ``n`` (one data-parallel rank's share, decoded as in a full
    pass: the RNG is seeded by the absolute index).
    """

    def __init__(self, items, augmentation="crop", batch_size=256,
                 num_workers=16, prefetch=4, seed=0, size=(224, 224),
                 fast_decode=True, start_batch=0, worker_kind="thread",
                 shard=None):
        self.items = items
        self.augmentation = augmentation
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.size = size
        self.fast_decode = fast_decode
        if worker_kind not in ("thread", "process"):
            raise ValueError(f"worker_kind {worker_kind!r}: thread/process")
        self.worker_kind = worker_kind
        self.start_batch = start_batch
        self.shard = shard
        self._native = None
        if fast_decode and augmentation == "crop" and size[0] == size[1]:
            from uml_tpu_torch import native

            if native.native_available():
                self._native = native.fast_decode_jpeg

    def __len__(self):
        return len(self._batch_indices())

    def _batch_indices(self):
        n = (len(self.items) + self.batch_size - 1) // self.batch_size
        indices = range(self.start_batch, n)
        if self.shard is not None:
            rank, size = self.shard
            indices = [i for i in indices if i % size == rank]
        return list(indices)

    def _decode_batch(self, batch_items, batch_idx):
        return _decode_batch_items(batch_items, batch_idx, self.augmentation,
                                   self.size, self.seed,
                                   self._native is not None)

    def __iter__(self):
        bs = self.batch_size
        batches = [(i, self.items[i * bs:(i + 1) * bs])
                   for i in self._batch_indices()]
        if self.worker_kind == "process":
            pool = _proc_pool(max(1, self.num_workers))  # persistent
            # the workers decode natively where this loader does, so that
            # ``decoder`` in the caches names what decoded
            yield from self._pump(
                batches,
                lambda b, idx: pool.submit(
                    _decode_batch_items, b, idx, self.augmentation,
                    self.size, self.seed, self._native is not None),
                pool.result, pool.drop)
            return
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
            yield from self._pump(
                batches,
                lambda b, idx: pool.submit(self._decode_batch, b, idx),
                lambda f: f.result(), lambda fs: [f.cancel() for f in fs])

    def _pump(self, batches, submit, wait, drop):
        """``prefetch`` (index, items) batches in flight, yielded in order;
        what is still in flight when the iteration stops is dropped."""
        pending = deque(submit(b, idx) for idx, b in batches[:self.prefetch])
        nxt = len(pending)
        try:
            while pending:
                if nxt < len(batches):
                    idx, b = batches[nxt]
                    pending.append(submit(b, idx))
                    nxt += 1
                yield wait(pending.popleft())
        finally:
            drop(pending)


class RawImageStream:
    """Infinite shuffled raw-image batches for full backbone finetuning
    (uml_tpu/data/loader.py:172-230).

    Each epoch draws a fresh permutation from ``core.prng.host_rng(seed)``
    and decodes with augmentation seeded per (epoch, batch index): the same
    stream as uml_tpu's (``crop`` through the native decoder, as there).
    Yields (uint8 flat [B, H*W*3], labels int64 [B], weights fp32 [B]); a
    partial final batch is padded to ``batch_size`` with zero weights.
    """

    def __init__(self, items, augmentation, batch_size, seed=0,
                 num_workers=8, size=(224, 224)):
        self.items = list(items)
        self.augmentation = augmentation
        self.batch_size = batch_size
        self.rng = host_rng(seed)
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
            epoch_perm(self.rng, len(self.items))
            epoch += 1
            skip_batches -= bpe
        while True:
            order = epoch_perm(self.rng, len(self.items))
            shuffled = [self.items[i] for i in order]
            loader = ImageBatchLoader(
                shuffled, self.augmentation, self.batch_size,
                num_workers=self.num_workers, seed=epoch, size=self.size,
                fast_decode=self.augmentation == "crop",
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
