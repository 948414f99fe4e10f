"""Minibatch standard-deviation layer of the discriminator epilogue (port of
``shgan_tpu/ops/minibatch_std.py``): appends per-group feature statistics
channels so the discriminator can see a lack of variety in a batch.

The groups are rows ``{i, i + N/G, ...}`` of the whole batch.  On a device
mesh the JAX package computes them over the global batch (the reshape of a
batch-sharded array is the one-device function under GSPMD, whatever its
docstring says of devices), so they span the ranks of a data-parallel run:
a rank (``rows``) gathers the global batch's features ([N, C, 4, 4] in the
discriminator), computes the statistic as one device would and keeps its
own rows.  The gather is differentiable to the second order (R1)."""

from __future__ import annotations

import torch


def minibatch_std(x, group_size=4, num_channels=1, rows=None):
    """x: [N, C, H, W] -> [N, C + num_channels, H, W].  N must be a multiple
    of the group (``min(group_size, N)``).  ``rows``: this worker's
    :class:`~shgan_torch.parallel.Rows` of a global batch (N its total), or
    None."""
    if rows is not None:
        y = minibatch_std(rows.gather(x), group_size, num_channels)
        return torch.cat([x, rows.take(y[:, x.shape[1]:])], dim=1)
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    if n % g:
        raise ValueError(f"minibatch_std: batch {n} is not a multiple of "
                         f"the group {g}")
    y = x.reshape(g, -1, f, c // f, h, w)     # [G n F c H W]
    y = y - y.mean(dim=0)                     # subtract the group mean
    y = y.square().mean(dim=0)                # variance over the group
    y = torch.sqrt(y + 1e-8)                  # stddev
    y = y.mean(dim=(2, 3, 4))                 # [n F]
    y = y.reshape(-1, f, 1, 1)
    y = y.repeat(g, 1, h, w)                  # [N F H W]
    return torch.cat([x, y.to(x.dtype)], dim=1)
