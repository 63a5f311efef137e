"""Host-side data feeding: shuffled batching with background prefetch.

Port of ``morefusion_tpu/training/data.py::BatchLoader``: a thread
prefetches transformed, stacked batches; ``num_workers > 0`` fans the
per-batch load and augmentation out to forked worker processes. The
shuffle is ``np.random.RandomState(seed)``'s, so the batch order is the
JAX package's. ``shard`` (a data-parallel rank's ``local_batch_slice``)
keeps those rows of every batch's indices: each rank draws the same global
shuffle and loads only its own rows. Workers run NumPy and cv2 only: tensors reach the device
in the parent (``loop.py``), never in a forked child.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from .trainer import stack_examples

#: batches the prefetch thread keeps ready ahead of the consumer
PREFETCH = 2

# fork-inherited handle so worker processes never pickle the dataset
# (set immediately before the pool forks; workers only receive indices)
_WORKER_LOADER = None


def _worker_make_batch(batch_idx):
    return _WORKER_LOADER._make_batch(batch_idx)


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        transform: Optional[Callable] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 0,
        indices: Optional[np.ndarray] = None,
        shard: Optional[slice] = None,
    ):
        self._dataset = dataset
        self._batch_size = batch_size
        self._transform = transform
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._drop_last = drop_last
        self._num_workers = int(num_workers)
        self._indices = (
            np.arange(len(dataset)) if indices is None else np.asarray(indices)
        )
        self._shard = shard
        #: a list to which the serial path appends each batch's ms
        self.batch_ms = None

    def __len__(self):
        n = len(self._indices)
        if self._drop_last:
            return n // self._batch_size
        return -(-n // self._batch_size)

    def _epoch_indices(self):
        idx = self._indices.copy()
        if self._shuffle:
            self._rng.shuffle(idx)
        return idx

    def _make_batch(self, batch_idx):
        if getattr(self._dataset, "supports_load_batch", False):
            # packed fast path: one fancy-indexed memmap read + vectorized
            # transform, no per-example npz decode (datasets/packed.py)
            batch = self._dataset.load_batch(batch_idx)
            if self._transform is None:
                return batch
            if hasattr(self._transform, "batch"):
                return self._transform.batch(batch)
            examples = [
                self._transform({k: v[i] for k, v in batch.items()})
                for i in range(len(batch_idx))
            ]
            return stack_examples(examples)
        examples = []
        for i in batch_idx:
            ex = self._dataset[int(i)]
            if self._transform is not None:
                ex = self._transform(ex)
            examples.append(ex)
        return stack_examples(examples)

    def _batch_index_list(self, idx):
        out = []
        for b in range(len(self)):
            lo = b * self._batch_size
            batch_idx = idx[lo : lo + self._batch_size]
            if self._drop_last and len(batch_idx) < self._batch_size:
                break
            if self._shard is not None:
                batch_idx = batch_idx[self._shard]
            out.append(batch_idx)
        return out

    def __iter__(self) -> Iterator[dict]:
        if self._num_workers > 0:
            yield from self._iter_multiprocess()
            return
        batches = self._batch_index_list(self._epoch_indices())
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            for batch_idx in batches:
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    item = self._make_batch(batch_idx)
                except Exception as e:  # surface loader errors to the consumer
                    put(e)
                    return
                if self.batch_ms is not None:
                    self.batch_ms.append((time.perf_counter() - t0) * 1e3)
                if not put(item):
                    return
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def _iter_multiprocess(self) -> Iterator[dict]:
        """Fan per-batch loading out to forked worker processes.

        Workers receive only index arrays (the dataset rides the fork
        image, never pickled); ``imap`` keeps epoch order, so the batches
        are those of the serial path for a given seed where the dataset
        draws no augmentation from a shared RNG (fork copies that RNG into
        every worker).
        """
        global _WORKER_LOADER
        batches = self._batch_index_list(self._epoch_indices())
        ctx = multiprocessing.get_context("fork")
        _WORKER_LOADER = self
        pool = ctx.Pool(self._num_workers)
        try:
            yield from pool.imap(
                _worker_make_batch, batches, chunksize=1
            )
        finally:
            pool.terminate()
            pool.join()
            _WORKER_LOADER = None
