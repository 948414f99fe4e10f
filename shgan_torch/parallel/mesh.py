"""The data-parallel mesh on ``torch.distributed`` (port of
``shgan_tpu/parallel/mesh.py``).

JAX shards a global batch over a device mesh and the compiler inserts the
collectives; here each rank is a process holding its contiguous block of
the global batch, and the collectives are explicit:

* gradients: one mean all-reduce over a flat buffer a network
  (:meth:`Mesh.average_grads`);
* the model's batch-wide statistics (the style normalization's mean over
  the whole batch, the discriminator's minibatch stddev, ``w_avg``'s batch
  mean, the path-length mean): the rank gathers the global batch's rows of
  the small tensor they read (:class:`Rows`) and computes the statistic as
  one device would, so a W-rank run computes what a W-device mesh does;
* broadcasts for the replica check (:mod:`.consistency`).

Gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` but not in
``all_gather``, so the device gather is a sum: each rank places its rows at
its offset in zeros and the ranks all-reduce (adding zeros is exact).  It
is differentiable to any order: its backward all-reduces the cotangents.

The mesh's ``model`` axis stays 1 until spatial sharding is ported.
:class:`ThreadGroup` gathers the same way between threads of one process
(the inference engine over several devices).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import multihost


@dataclass(frozen=True)
class Rows:
    """Rows ``[start, stop)`` of a global batch of ``total`` rows, held by
    one worker of ``group`` (a :class:`Mesh` or :class:`ThreadGroup`),
    whose other workers hold the rest."""
    start: int
    stop: int
    total: int
    group: object

    def gather(self, t):
        """The global batch's rows of ``t`` (this worker's ``[stop -
        start, ...]``), in order; differentiable on a :class:`Mesh`."""
        return self.group.gather_rows(t, self)

    def take(self, t):
        """This worker's rows of a tensor of the global batch."""
        return t[self.start:self.stop]

    def draw(self, fn, shape):
        """This worker's rows of ``fn(shape with the global row count)``:
        a per-row random draw that equals the one-device draw's rows."""
        return self.take(fn((self.total,) + tuple(shape[1:])))


def split(n, world, rank):
    """The contiguous block ``(start, stop)`` of ``n`` rows for ``rank`` of
    ``world`` equal blocks."""
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over "
                         f"{world} ranks")
    k = n // world
    return rank * k, (rank + 1) * k


class _AllReduceSum(torch.autograd.Function):
    """Sum over the mesh's ranks; its backward is the same sum of the
    cotangents (each rank's loss reads every rank's rows)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        out = t.contiguous().clone()
        mesh.all_reduce_(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.mesh), None


class Mesh:
    """The ranks of a data-parallel run: ``world`` processes, this one
    ``rank`` on ``device``; ``group`` the device collectives' process group
    (None: the default group)."""

    model = 1

    def __init__(self, world=1, rank=0, device=None, group=None,
                 backend=None):
        self.world, self.rank = world, rank
        self.device = torch.device(device) if device is not None else None
        self.group, self.backend = group, backend

    def __repr__(self):
        return (f"Mesh(world={self.world}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def split(self, n):
        return split(n, self.world, self.rank)

    def rows(self, total):
        """This rank's :class:`Rows` of a global batch of ``total``, or
        None on one rank (the batch is whole)."""
        if self.world == 1:
            return None
        return Rows(*self.split(total), total, self)

    def batch_rows(self, n, rounds=1):
        """This rank's rows (indices) of a global batch of ``n`` cut into
        ``rounds`` equal rounds (gradient accumulation): its block of each
        round, in round order."""
        if n % rounds:
            raise ValueError(f"batch {n} is not a multiple of {rounds} "
                             "rounds")
        m = n // rounds
        lo, hi = self.split(m)
        return [r * m + i for r in range(rounds) for i in range(lo, hi)]

    def shard_batch(self, batch):
        """This rank's rows of each array of a global batch."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self.shard_batch(b) for b in batch)
        lo, hi = self.split(batch.shape[0])
        return batch[lo:hi]

    def all_reduce_(self, t):
        """Sum ``t`` over the ranks, in place."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean_(self, t):
        """Mean of ``t`` over the ranks, in place."""
        if self.world > 1:
            self.all_reduce_(t).div_(self.world)
        return t

    def broadcast_(self, t, src=0):
        if self.world > 1:
            dist.broadcast(t, src, group=self.group)
        return t

    def gather_rows(self, t, rows):
        """The sum-gather: ``t`` at ``rows.start`` in zeros of the global
        batch's shape, summed over the ranks (differentiable)."""
        pad = [t.new_zeros((rows.start,) + t.shape[1:]), t,
               t.new_zeros((rows.total - rows.stop,) + t.shape[1:])]
        return _AllReduceSum.apply(torch.cat(pad), self)

    @torch.no_grad()
    def average_grads(self, params):
        """Every parameter's ``.grad`` averaged over the ranks in one flat
        buffer (a missing gradient counts as zeros and is set)."""
        params = list(params)
        if self.world == 1 or not params:
            return
        flat = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1).float() for p in params])
        self.all_reduce_mean_(flat)
        at = 0
        for p in params:
            n = p.numel()
            p.grad = flat[at:at + n].view_as(p).to(p.dtype)
            at += n


def create_mesh(n_devices=None, device=None, backend=None):
    """The mesh of this process: every rank of the process group (or this
    process alone), on ``device`` (default: the rank's device, else the
    CUDA device).  ``n_devices``, where given with a process group, must be
    its size.  ``backend`` asks for the device collectives' backend
    (``env.dist_backend``; default by :func:`~.multihost.pick_backend`)."""
    world, rank = multihost.world_size(), multihost.rank()
    if n_devices is not None and world > 1 and int(n_devices) != world:
        raise ValueError(f"env.mesh_devices {n_devices}, but {world} ranks "
                         "joined: one rank a device")
    if device is None:
        device = multihost.local_device()
    if device is None:
        from ..serve import resolve_device
        device = resolve_device(None)
    name, group = multihost.device_group(backend)   # (None, None) alone
    return Mesh(world, rank, device, group, name)


class ThreadGroup:
    """``n`` workers of one process, a thread each, that gather rows
    through shared slots and a barrier (the engine over several devices).
    A worker that fails calls :meth:`abort`, so the others stop waiting."""

    def __init__(self, n):
        self.n = n
        self._barrier = threading.Barrier(n)
        self._slots = {}

    def gather_rows(self, t, rows):
        self._slots[rows.start] = t
        self._barrier.wait()
        out = torch.cat([self._slots[k].to(t.device)
                         for k in sorted(self._slots)])
        self._barrier.wait()   # every worker has read before any writes
        return out

    def abort(self):
        self._barrier.abort()
