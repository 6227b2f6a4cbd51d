"""Batched host loader with threaded decode and transfer to the card (the
JAX package's ``data/loader.py``, one process).

A thread pool of ``num_workers`` decodes samples (PIL releases the GIL),
:data:`PREFETCH` batches are in flight beyond the one being consumed, and
each collated batch is moved to ``device`` one batch ahead of the consumer:
``torch.from_numpy(...).pin_memory().to(device, non_blocking=True)`` for a
CUDA device; on the CPU (or ``device=None``) batches are host tensors.
Arrays are stacked; other fields (``frame_path``) become lists and stay on
the host.

The batch-index sequence is the JAX loader's: ``np.random.default_rng(seed
+ epoch)`` shuffles the indices, ``drop_last`` drops a partial last batch,
and ``pad_last`` fills it by repeating its last index and reports the true
count in ``__valid_n__`` (a host int). Multi-process slicing of each batch
is DDP's (ROADMAP Queue A, DDP over NCCL).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator

import numpy as np
import torch


# Batches being decoded beyond the one the consumer holds.
PREFETCH = 2


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8, seed: int = 0,
                 pad_last: bool = False, device=None):
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
        """Yields (index array, true count) per batch."""
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

    @staticmethod
    def _collate(samples):
        batch = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            batch[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        return batch

    def _host_batches(self) -> Iterator[dict]:
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()

            def finish():
                futures, true_n = pending.popleft()
                batch = self._collate([f.result() for f in futures])
                if self.pad_last:
                    batch["__valid_n__"] = true_n
                return batch

            for idxs, true_n in self._batch_indices():
                pending.append(([pool.submit(self.dataset.__getitem__, int(i))
                                 for i in idxs], true_n))
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
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                if self.device is not None and self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
            else:
                out[k] = v
        return out

