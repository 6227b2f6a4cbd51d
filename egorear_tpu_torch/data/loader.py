"""Batched host loader with threaded decode and transfer to the card (the
JAX package's ``data/loader.py``).

A thread pool of ``num_workers`` decodes samples (the native decoder and
PIL release the GIL) and each worker copies its sample's arrays straight
into its row of the batch's tensors, which lie in pinned memory when
``device`` is a CUDA device: the consumer's thread neither stacks nor
pins a batch (a stage-2 batch of uint8 872-px views is 584 MB).
:data:`PREFETCH` batches are in flight beyond the one being consumed, and
each batch is moved to ``device`` one batch ahead of the consumer
(``.to(device, non_blocking=True)`` from the pinned rows); on the CPU (or
``device=None``) batches are host tensors. Other fields (``frame_path``)
become lists and stay on the host.

The batch-index sequence is the JAX loader's: ``np.random.default_rng(seed
+ epoch)`` shuffles the indices, ``drop_last`` drops a partial last batch,
and ``pad_last`` fills it by repeating its last index and reports the true
count in ``__valid_n__`` (a host int, the global batch's).

Data-parallel (``shard``, a :class:`~egorear_tpu_torch.parallel.dist.
DataShard` of W ranks): every rank walks the same global index sequence
and loads only its contiguous B/W rows of each batch, as the JAX loader's
processes do; W must divide B. ``num_workers`` threads are per process.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import threading
from typing import Iterator

import numpy as np
import torch


# Batches being decoded beyond the one the consumer holds.
PREFETCH = 2


class _Batch:
    """One batch that the workers fill: the first sample to arrive sets
    each array field's (n, ...) tensor (pinned when ``pin``), and every
    sample's arrays are copied into their row; other fields are kept by
    row in lists."""

    def __init__(self, n: int, pin: bool):
        self.n, self.pin = n, pin
        self.lock = threading.Lock()
        self.keys = None
        self.tensors, self.rows, self.lists = {}, {}, {}

    def put(self, j: int, sample: dict) -> None:
        with self.lock:
            if self.keys is None:
                for k, v in sample.items():
                    if isinstance(v, np.ndarray):
                        dtype = torch.from_numpy(np.empty(0, v.dtype)).dtype
                        t = torch.empty((self.n,) + v.shape, dtype=dtype,
                                        pin_memory=self.pin)
                        self.tensors[k], self.rows[k] = t, t.numpy()
                    else:
                        self.lists[k] = [None] * self.n
                self.keys = list(sample)
        for k, rows in self.rows.items():
            rows[j] = sample[k]
        for k, values in self.lists.items():
            values[j] = sample[k]

    def result(self) -> dict:
        return {k: self.tensors[k] if k in self.tensors else self.lists[k]
                for k in self.keys}


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8, seed: int = 0,
                 pad_last: bool = False, device=None, shard=None):
        if shard is not None:
            shard.rows(batch_size)  # raises unless the ranks divide the batch
            if not (drop_last or pad_last):
                raise ValueError("a sharded loader needs full batches: "
                                 "drop_last or pad_last")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.pad_last = pad_last
        self.device = None if device is None else torch.device(device)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        """Yields (global index array, true count) per batch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            idxs = order[i:i + self.batch_size]
            true_n = len(idxs)
            if self.pad_last and true_n < self.batch_size:
                idxs = np.concatenate(
                    [idxs, np.repeat(idxs[-1:], self.batch_size - true_n)])
            yield idxs, true_n

    def _fill(self, batch: _Batch, j: int, i: int) -> None:
        batch.put(j, self.dataset[i])

    def _host_batches(self) -> Iterator[dict]:
        pin = self.device is not None and self.device.type == "cuda"
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()

            def finish():
                batch, futures, true_n = pending.popleft()
                for f in futures:
                    f.result()
                out = batch.result()
                if self.pad_last:
                    out["__valid_n__"] = true_n
                return out

            for idxs, true_n in self._batch_indices():
                if self.shard is not None:
                    idxs = idxs[self.shard.rows(self.batch_size)]
                batch = _Batch(len(idxs), pin)
                pending.append((batch, [pool.submit(self._fill, batch, j, int(i))
                                        for j, i in enumerate(idxs)], true_n))
                if len(pending) > PREFETCH:
                    yield finish()
            while pending:
                yield finish()

    def __iter__(self) -> Iterator[dict]:
        queue: collections.deque = collections.deque()
        for host_batch in self._host_batches():
            queue.append(self._transfer(host_batch))
            if len(queue) > 1:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def _transfer(self, batch: dict) -> dict:
        if self.device is None or self.device.type != "cuda":
            return batch
        return {k: v.to(self.device, non_blocking=True) if torch.is_tensor(v) else v
                for k, v in batch.items()}

