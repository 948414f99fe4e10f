"""Deterministic data sharding (port of ``shgan_tpu/data/sampler.py``,
without the device-image-bank rows).

Every shard derives the same order from the same seed and takes its own
contiguous block; per-batch validity masks mark the rows that pad the last
batch (evaluators drop them).
"""

from __future__ import annotations

import numpy as np

from .rng import batch_rng, derive_seed


def shard_indices(n, shard_id=0, num_shards=1, shuffle=False, seed=0,
                  extend=True):
    """Return (indices, valid) for this shard.  extend=True pads the global
    order from its own front so every shard has ceil(n/num_shards)
    entries; ``valid`` marks the non-padded entries."""
    order = np.arange(n, dtype=np.int64)
    if shuffle:
        order = np.random.RandomState(seed).permutation(n).astype(np.int64)
    valid = np.ones(n, dtype=bool)
    per = -(-n // num_shards)
    total = per * num_shards
    if total > n:
        if extend:
            pad = total - n
            order = np.concatenate([order, order[:pad]])
            valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
        else:
            per = n // num_shards
            order = order[: per * num_shards]
            valid = valid[: per * num_shards]
    return (order[shard_id * per:(shard_id + 1) * per],
            valid[shard_id * per:(shard_id + 1) * per])


class DataShard:
    """A dataset shard in fixed-size batches with a validity mask; the last
    batch is padded by repeating its final element so shapes stay fixed.

    ``get_batch(b)`` is thread-safe and deterministic: each sample formats
    under a per-(seed, epoch, global position) RNG scope, so the stream is
    the same for any worker-thread count and any shard count.

    ``transport``: 'f32' yields real float32 in [-1, 1] and mask float32;
    'u8' yields real uint8 0..255 and mask uint8 {0, 1} (normalized on the
    device, bit-identical for uint8-sourced images)."""

    def __init__(self, dataset, formatter, batch_size, shard_id=0,
                 num_shards=1, shuffle=False, seed=0, extend=True,
                 drop_last=False, epoch=0, transport="f32"):
        if transport not in ("f32", "u8"):
            raise ValueError(f"transport {transport!r}: 'f32' or 'u8'")
        self.dataset = dataset
        self.formatter = formatter
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = epoch
        self.transport = transport
        self.indices, self.valid = shard_indices(
            len(dataset), shard_id, num_shards, shuffle, seed, extend)
        self.global_offset = shard_id * len(self.indices)
        if drop_last:
            k = (len(self.indices) // batch_size) * batch_size
            self.indices, self.valid = self.indices[:k], self.valid[:k]

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)

    def get_batch(self, b, rows=None):
        """Batch ``b``; ``rows`` (indices into the batch) formats only
        those rows, each as the whole batch would."""
        bs = self.batch_size
        idx = self.indices[b * bs:(b + 1) * bs]
        val = self.valid[b * bs:(b + 1) * bs]
        if len(idx) < bs:
            pad = bs - len(idx)
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            val = np.concatenate([val, np.zeros(pad, dtype=bool)])
        js = np.arange(bs) if rows is None else np.asarray(rows)
        idx, val = idx[js], val[js]
        u8 = self.transport == "u8"
        reals, masks, uids = [], [], []
        for j, i in zip(js, idx):
            pos = self.global_offset + b * bs + int(j)
            with batch_rng(derive_seed(self.seed, pos, self.epoch)):
                r, m, u = self.formatter(self.dataset[int(i)])
            r = np.asarray(r)
            if u8:
                if r.dtype != np.uint8:
                    # exact inverse of the device-side u/127.5-1 for images
                    # that were uint8 to begin with
                    r = np.clip(np.rint((r.astype(np.float32) + 1.0)
                                        * 127.5), 0, 255).astype(np.uint8)
                reals.append(r)
                masks.append(np.asarray(m) > 0.5)
            else:
                if r.dtype == np.uint8:
                    r = r.astype(np.float32) / 127.5 - 1.0
                reals.append(r.astype(np.float32, copy=False))
                masks.append(np.asarray(m, np.float32))
            uids.append(u)
        real = np.stack(reals)
        mask = np.stack(masks)[:, None]
        if u8:
            mask = mask.astype(np.uint8)
        return (real, mask, val, uids)

    def __iter__(self):
        for b in range(len(self)):
            yield self.get_batch(b)
