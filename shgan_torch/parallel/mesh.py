"""The device mesh on ``torch.distributed`` (port of
``shgan_tpu/parallel/mesh.py``): a ``data`` axis that splits the batch and a
``model`` axis that splits the high-resolution planes along H
(:mod:`.spatial`), laid out as the JAX mesh is, data-major:
``rank = data_index * model + model_index``.

JAX shards a global batch over a device mesh and the compiler inserts the
collectives; here each rank is a process holding its contiguous block of
the global batch, and the collectives are explicit:

* gradients: one mean all-reduce over the data group of a flat buffer a
  network (:meth:`Mesh.average_grads`; the ranks of a model group hold the
  same rows and, by :mod:`.spatial`'s gradient rule, the same whole
  gradients: they are checked to agree and model index 0's are kept);
* the model's batch-wide statistics (the style normalization's mean over
  the whole batch, the discriminator's minibatch stddev, ``w_avg``'s batch
  mean, the path-length mean): the rank gathers the global batch's rows of
  the small tensor they read (:class:`Rows`, over the data group) and
  computes the statistic as one device would, so a W-rank run computes what
  a W-device mesh does;
* broadcasts for the replica check (:mod:`.consistency`), over every rank;
* on the model group: sums (the spatial gather and the gradient rule) and
  the point-to-point halo exchange (:meth:`Mesh.exchange`).

Where a profiler records (``runtime/tracing.span``), each gradient
all-reduce is a ``dist.grads`` span and each gather of rows a ``dist.rows``
span (the forward's and the backward's), each with its ``bytes``; the
mesh's ``traffic`` counts them always (``grad_calls`` / ``grad_bytes``,
``rows_calls`` / ``rows_bytes``).  One rank records nothing of either.

Gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` but not in
``all_gather``, so the device gather is a sum: each rank places its rows at
its offset in zeros and the ranks all-reduce (adding zeros is exact).  It
is differentiable to any order: its backward all-reduces the cotangents.

:class:`ThreadGroup` gathers the same way between threads of one process
(the inference engine over several devices).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..runtime.tracing import span
from . import multihost

# how far (relative to a leaf's norm) a model group's copies of a gradient
# may round apart before average_grads refuses them
MODEL_GRAD_RTOL = 1e-3


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
    """Sum over the ranks of the mesh's data group; its backward is the
    same sum of the cotangents (each rank's loss reads every rank's
    rows), through this function again, so each sum, forward or backward,
    is one ``dist.rows`` span and one count of ``rows_calls``."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        out = t.contiguous().clone()
        nbytes = out.numel() * out.element_size()
        mesh.traffic["rows_calls"] += 1
        mesh.traffic["rows_bytes"] += nbytes
        with span("dist.rows", bytes=nbytes):
            mesh.data_all_reduce_(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.mesh), None


class Mesh:
    """The ranks of a run: ``world`` processes, this one ``rank`` on
    ``device``, ``world / model`` data ranks by ``model`` model ranks;
    ``group`` the device collectives' process group over every rank (None:
    the default group), ``data_group`` / ``model_group`` this rank's data
    and model groups (with ``model`` 1 the data group is ``group``)."""

    def __init__(self, world=1, rank=0, device=None, group=None,
                 backend=None, model=1, data_group=None, model_group=None):
        if model < 1 or world % model:
            raise ValueError(f"a model axis of {model} does not divide "
                             f"{world} ranks")
        self.world, self.rank = world, rank
        self.device = torch.device(device) if device is not None else None
        self.group, self.backend = group, backend
        self.model = model
        self.data = world // model
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group = group if model == 1 else data_group
        self.model_group = model_group
        # bytes this rank sent on the model group: halo rows (and their
        # cotangents) through exchange, and the planes it summed; on the
        # data group: the gradient all-reduces and the gathers of rows
        # (calls and bytes)
        self.traffic = {"halo_bytes": 0, "sum_bytes": 0, "grad_calls": 0,
                        "grad_bytes": 0, "rows_calls": 0, "rows_bytes": 0}
        # the largest gap between a model group's copies of a gradient,
        # relative to its norm, that average_grads has seen
        self.replica_gap = 0.0

    def __repr__(self):
        return (f"Mesh(world={self.world}, rank={self.rank}, "
                f"data={self.data}, model={self.model}, "
                f"device={self.device}, backend={self.backend})")

    def split(self, n):
        return split(n, self.data, self.data_index)

    def rows(self, total):
        """This rank's :class:`Rows` of a global batch of ``total``, or
        None on one data rank (the batch is whole)."""
        if self.data == 1:
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
        """Sum ``t`` over every rank, in place."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean_(self, t):
        """Mean of ``t`` over every rank, in place."""
        if self.world > 1:
            self.all_reduce_(t).div_(self.world)
        return t

    def data_all_reduce_(self, t):
        """Sum ``t`` over this rank's data group, in place."""
        if self.data > 1:
            dist.all_reduce(t, group=self.data_group)
        return t

    def model_all_reduce_(self, t):
        """Sum ``t`` over this rank's model group, in place."""
        if self.model > 1:
            self.traffic["sum_bytes"] += t.numel() * t.element_size()
            dist.all_reduce(t, group=self.model_group)
        return t

    def model_mean(self, t):
        """The mean of ``t`` over this rank's model group: one value for a
        replicated tensor whose ranks' copies may round apart."""
        if self.model == 1:
            return t
        return self.model_all_reduce_(t.detach().clone()).div_(self.model)

    def broadcast_(self, t, src=0):
        if self.world > 1:
            dist.broadcast(t, src, group=self.group)
        return t

    def model_rank(self, index):
        """The global rank of model index ``index`` of this rank's model
        group."""
        return self.data_index * self.model + index

    @property
    def transport(self):
        """How :meth:`exchange` moves rows: NCCL's point-to-point between
        devices, or gloo's between hosts (a CUDA tensor staged through
        one)."""
        if self.backend == "nccl":
            return "nccl"
        staged = self.device is not None and self.device.type == "cuda"
        return "gloo via host" if staged else "gloo"

    def exchange(self, sends, recvs):
        """Point-to-point over the model group: ``sends`` maps a model index
        to a tensor for it, ``recvs`` a model index to a tensor to fill from
        it (each rank names its side of every pair).  NCCL sends device
        tensors in one batch; gloo sends host tensors, so a CUDA tensor
        travels through a host copy.  Returns ``recvs``."""
        self.traffic["halo_bytes"] += sum(t.numel() * t.element_size()
                                          for t in sends.values())
        host = self.transport == "gloo via host"
        out = {k: t.detach().cpu() if host else t.detach().contiguous()
               for k, t in sends.items()}
        into = {k: torch.empty(t.shape, dtype=t.dtype) if host else t
                for k, t in recvs.items()}
        ops = [dist.P2POp(dist.isend, t, self.model_rank(k),
                          group=self.model_group) for k, t in out.items()]
        ops += [dist.P2POp(dist.irecv, t, self.model_rank(k),
                           group=self.model_group) for k, t in into.items()]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if host:
            for k, t in recvs.items():
                t.copy_(into[k])
        return recvs

    def gather_rows(self, t, rows):
        """The sum-gather: ``t`` at ``rows.start`` in zeros of the global
        batch's shape, summed over the data group (differentiable)."""
        pad = [t.new_zeros((rows.start,) + t.shape[1:]), t,
               t.new_zeros((rows.total - rows.stop,) + t.shape[1:])]
        return _AllReduceSum.apply(torch.cat(pad), self)

    @torch.no_grad()
    def average_grads(self, params):
        """Every parameter's ``.grad`` averaged over the data group in one
        flat buffer (a missing gradient counts as zeros and is set).  The
        ranks of a model group hold the same whole gradients by
        :mod:`.spatial`'s gradient rule, up to the last bits of ops that
        need not round alike in two processes (cuDNN's weight gradient, an
        atomic scatter): each leaf must agree with model index 0's within
        :data:`MODEL_GRAD_RTOL` of its norm, else ValueError (a replicated tensor entered a slab op without the
        rule), and model index 0's is kept, so the replicas stay bit for
        bit."""
        params = list(params)
        if self.world == 1 or not params:
            return
        with span("dist.grads") as sp:
            flat = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1).float() for p in params])
            nbytes = flat.numel() * flat.element_size()
            sp.set(bytes=nbytes)
            if self.data > 1:
                self.traffic["grad_calls"] += 1
                self.traffic["grad_bytes"] += nbytes
                self.data_all_reduce_(flat).div_(self.data)
            if self.model > 1:
                flat = self._model_agreed(flat, params)
            at = 0
            for p in params:
                n = p.numel()
                p.grad = flat[at:at + n].view_as(p).to(p.dtype)
                at += n

    def _model_agreed(self, flat, params):
        """Model index 0's ``flat``, once every rank of the model group
        has checked its leaves against it (:meth:`average_grads`)."""
        ref = flat.clone()
        dist.broadcast(ref, self.model_rank(0), group=self.model_group)
        sizes = torch.tensor([p.numel() for p in params], device=flat.device)
        seg = torch.repeat_interleave(
            torch.arange(len(params), device=flat.device), sizes)
        sq = torch.zeros(2, len(params), dtype=torch.float64,
                         device=flat.device)
        sq[0].index_add_(0, seg, (flat - ref).double() ** 2)
        sq[1].index_add_(0, seg, ref.double() ** 2)
        gap = (sq[0].sqrt() / sq[1].sqrt().clamp_min(1e-30)).nan_to_num(0.0)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=self.model_group)
        worst = int(gap.argmax())
        self.replica_gap = max(self.replica_gap, float(gap[worst]))
        if float(gap[worst]) > MODEL_GRAD_RTOL:
            raise ValueError(
                f"the model group's gradients of parameter {worst} (shape "
                f"{tuple(params[worst].shape)}) differ by {float(gap[worst])}"
                f" of its norm (> {MODEL_GRAD_RTOL}): a replicated tensor "
                "entered a slab op without spatial.replicated")
        return ref


def create_mesh(n_devices=None, device=None, backend=None, model=1):
    """The mesh of this process: every rank of the process group (or this
    process alone), on ``device`` (default: the rank's device, else the
    CUDA device), ``model`` ranks a model group (JAX's ``create_mesh(
    n_devices, data=None, model=1)``).  ``n_devices``, where given with a
    process group, must be its size.  ``backend`` asks for the device
    collectives' backend (``env.dist_backend``; default by
    :func:`~.multihost.pick_backend`).  Every rank makes every data and
    model group, in the same order."""
    world, rank = multihost.world_size(), multihost.rank()
    if n_devices is not None and world > 1 and int(n_devices) != world:
        raise ValueError(f"env.mesh_devices {n_devices}, but {world} ranks "
                         "joined: one rank a device")
    model = int(model)
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} "
                         "ranks")
    if device is None:
        device = multihost.local_device()
    if device is None:
        from ..serve import resolve_device
        device = resolve_device(None)
    name, group = multihost.device_group(backend)   # (None, None) alone
    data_group = model_group = None
    if model > 1:
        data = world // model
        for d in range(data):
            g = multihost.subgroup(name, [d * model + m for m in range(model)])
            if d == rank // model:
                model_group = g
        for m in range(model):
            g = multihost.subgroup(name, [d * model + m for d in range(data)])
            if m == rank % model:
                data_group = g
    return Mesh(world, rank, device, group, name, model, data_group,
                model_group)


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
