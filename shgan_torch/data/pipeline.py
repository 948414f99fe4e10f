"""Host-side eval and train pipelines with parallel background prefetch
(port of ``_Prefetcher``, ``EvalPipeline`` and ``TrainPipeline`` of
``shgan_tpu/data/pipeline.py``).

Across ranks: :class:`EvalPipeline` takes the rank's contiguous shard of
the dataset in batches of the rank's rows (the JAX package's per-process
shard: rows gathered in rank order restore the dataset's order);
:class:`TrainPipeline` yields the rank's rows of each global batch of the
one-process stream, so a W-rank run trains on the batches a one-process run
does.

A thread pool builds whole batches concurrently (PIL decode and numpy
release the GIL), results are yielded in order, and each batch is copied to
the device inside its worker, so the upload of batch i+1 overlaps the
device's work on batch i.  On a CUDA device the copy goes through pinned
memory with ``non_blocking=True``.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch

from .sampler import DataShard


def default_num_threads(cap=8):
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        n = os.cpu_count() or 1
    return max(1, min(n, cap))


def _to_device(arr, device):
    """numpy → a tensor on ``device``; to a CUDA device through pinned
    memory, without blocking."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Prefetcher:
    """Ordered parallel prefetch over ``make_batch(0..n_batches-1)``.

    Up to ``max(depth, num_threads)`` batches are in flight on a
    ``num_threads``-wide pool; results yield strictly in order.
    ``num_threads=0`` → synchronous."""

    def __init__(self, make_batch, n_batches, depth=4, num_threads=None):
        self.make_batch = make_batch
        self.n_batches = n_batches
        self.depth = depth
        self.num_threads = (default_num_threads() if num_threads is None
                            else num_threads)

    def __iter__(self):
        n = self.n_batches
        if self.num_threads <= 0:
            for b in range(n):
                yield self.make_batch(b)
            return
        window = max(self.depth, self.num_threads)
        ex = ThreadPoolExecutor(self.num_threads)
        try:
            inflight = deque()
            nxt = 0
            while nxt < min(window, n):
                inflight.append(ex.submit(self.make_batch, nxt))
                nxt += 1
            while inflight:
                batch = inflight.popleft().result()
                if nxt < n:
                    inflight.append(ex.submit(self.make_batch, nxt))
                    nxt += 1
                yield batch
        finally:
            # an abandoned iterator does not wait for queued batch builds
            ex.shutdown(wait=False, cancel_futures=True)


class EvalPipeline:
    """Sequential (no shuffle, extend=True) evaluation pipeline.

    Yields ``(real, mask, valid, uids)``: ``real``/``mask`` as torch tensors
    on ``device`` (numpy arrays when ``device`` is None), ``valid`` a bool
    numpy array of the rows that are not padding, ``uids`` the unique
    ids."""

    def __init__(self, dataset, formatter, batch_size, device=None, depth=4,
                 seed=0, num_threads=None, transport="f32", shard_id=0,
                 num_shards=1):
        """``batch_size``: the rows of each batch of this shard (a rank's
        share of the global batch); ``shard_id`` of ``num_shards``: the
        rank's contiguous shard, padded (``valid`` False) to equal
        lengths."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = None if device is None else torch.device(device)
        self.shard = DataShard(dataset, formatter, batch_size, shuffle=False,
                               extend=True, seed=seed, transport=transport,
                               shard_id=shard_id, num_shards=num_shards)
        make = (self.shard.get_batch if self.device is None
                else self._worker_batch)
        self.prefetch = _Prefetcher(make, len(self.shard), depth=depth,
                                    num_threads=num_threads)

    def _worker_batch(self, b):
        real, mask, valid, uids = self.shard.get_batch(b)
        return (_to_device(real, self.device), _to_device(mask, self.device),
                valid, uids)

    def __len__(self):
        return len(self.shard)

    def __iter__(self):
        return iter(self.prefetch)


class TrainPipeline:
    """Infinite shuffled pipeline: epoch ``e`` shuffles with seed
    ``seed + e`` and drops the last partial batch.  Yields ``(real, mask)``
    as torch tensors on ``device`` (numpy arrays when ``device`` is None),
    copied as in :class:`EvalPipeline`.  ``start`` skips that many batches
    of the stream (a resumed run continues where its snapshot was taken).
    ``batch_size`` is the global batch; ``rows`` (indices into it, default
    all) the rows this rank takes of each."""

    def __init__(self, dataset, formatter, batch_size, device=None, depth=4,
                 seed=0, num_threads=None, start=0, rows=None):
        self.dataset = dataset
        self.formatter = formatter
        self.batch_size = batch_size
        self.device = None if device is None else torch.device(device)
        self.depth = depth
        self.seed = seed
        self.num_threads = num_threads
        self.start = start
        self.rows = rows

    def __iter__(self):
        epoch, skip = 0, self.start
        while True:
            shard = DataShard(self.dataset, self.formatter, self.batch_size,
                              shuffle=True, seed=self.seed + epoch,
                              extend=False, drop_last=True, epoch=epoch)
            if len(shard) == 0:
                raise ValueError(f"dataset of {len(self.dataset)} holds no "
                                 f"batch of {self.batch_size}")

            first = min(skip, len(shard))
            skip -= first

            def make(b, shard=shard, first=first):
                real, mask, _valid, _uids = shard.get_batch(first + b,
                                                            self.rows)
                if self.device is None:
                    return real, mask
                return (_to_device(real, self.device),
                        _to_device(mask, self.device))
            yield from _Prefetcher(make, len(shard) - first,
                                   depth=self.depth,
                                   num_threads=self.num_threads)
            epoch += 1
