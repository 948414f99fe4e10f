"""Spatial (height) sharding of the high-resolution levels over the mesh's
``model`` axis (port of ``shgan_tpu/parallel/spatial.py``).

The JAX package annotates: :func:`constrain` puts a sharding constraint on
the activations of every level at ``H >= min_res`` (``H`` divisible by the
model axis), and its compiler places the halo exchanges the 3×3 convs and
FIR resamplers need.  Eager PyTorch has no compiler to do that, so here the
layers run each sharded level on a :class:`Slab`: a rank holds rows ``[h0,
h1)`` of the plane, and before an op that reads rows beyond them it takes
the neighbours' rows it needs (the halo) through :meth:`Mesh.exchange
<shgan_torch.parallel.mesh.Mesh.exchange>`.  A rank never holds a whole
sharded plane, except where the model reads one (the SHU's spectrum, the
final image).

Usage, as in JAX (no config key or CLI flag turns it on)::

    mesh = create_mesh(model=2)         # every rank, a model group of 2
    with spatial_sharding(mesh, min_res=512):
        img = G(x, z, ...)              # >= 512² levels on slabs

No-op when inactive (the default) or when the mesh's model axis is 1.

The levels.  :func:`level` says whether the activations of a resolution
are slabs: ``H >= min_res`` and ``H % model == 0`` (JAX's rule), and also
at least :data:`HALO` rows a rank, an even number of them (a level whose
rank's rows are fewer than its ops' halo, or not a multiple of ``down`` =
2, stays whole, as an indivisible level stays whole in JAX; so does the
4² level of the encoder's epilogue and the first synthesis block, whose
dense layers read the whole plane).

The gradient rule.  Every tensor here is one of: replicated (equal on the
ranks of a model group: weights, styles, whole planes), a slab, or a
partial sum (a rank's share of a sum over the plane: the gradient of a
replicated tensor that a slab op read).  A replicated tensor enters a slab
op through :func:`replicated` (identity; backward: the sum over the model
group) and a slab leaves as a whole plane through :meth:`Slab.gather` (the
sum-gather; backward: the rank's rows), the f / g pair of tensor
parallelism.  Each backward is again one of these operations, so every
order of derivative (the path-length penalty's, R1's) is the unsharded
one's, and every parameter's gradient is whole and equal on the ranks of a
model group.  :meth:`Slab.halo`'s backward adds the cotangents of the halo
rows into the neighbours' rows.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.nn.functional as F

HALO = 2   # the most rows an op of a sharded level reads beyond its slab

_STATE = threading.local()

def spatial_sharding(mesh, min_res=512):
    """Run the levels at ``H >= min_res`` (divisible by the model axis) on
    slabs over the mesh's model axis."""
    return within((mesh, int(min_res)))


def state():
    """This thread's sharding state, for :func:`within` (None: none)."""
    return getattr(_STATE, "cfg", None)


@contextmanager
def within(cfg):
    """Run under the sharding state ``cfg`` of :func:`state` (the autograd
    engine's device thread, which recomputes a checkpointed block, does not
    see the caller's)."""
    prev = state()
    _STATE.cfg = cfg
    try:
        yield
    finally:
        _STATE.cfg = prev


def active():
    """``(mesh, min_res)`` inside :func:`spatial_sharding` with a model axis
    above 1, else None."""
    cfg = state()
    if cfg is None or cfg[0].model <= 1:
        return None
    return cfg


def level(res):
    """This rank's :class:`Slab` of the planes at resolution ``res``, or
    None where the level stays whole."""
    cfg = active()
    if cfg is None:
        return None
    mesh, min_res = cfg
    m = mesh.model
    if res < min_res or res % m or res <= 4:   # 4²: the dense blocks
        return None
    rows = res // m
    if rows < HALO or rows % 2:
        return None
    h0 = mesh.model_index * rows
    return Slab(h0, h0 + rows, res, mesh)


def constrain(x):
    """The rank's rows of an NCHW plane whose level is sharded (a slab of
    it); identity otherwise.  Safe on any value (non-4-D and small tensors
    pass through)."""
    if active() is None or getattr(x, "ndim", 0) != 4:
        return x
    slab = level(x.shape[2])
    return x if slab is None else slab.take(x)


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _sum_(t, mesh):
    return mesh.model_all_reduce_(t)


class _Copy(torch.autograd.Function):
    """Identity on a replicated tensor that a slab op reads; backward: the
    sum of the ranks' partial cotangents (:class:`_Sum`)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.mesh), None


class _Sum(torch.autograd.Function):
    """The sum over the model group of the ranks' partial sums; backward:
    identity (:class:`_Copy`)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _sum_(t.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh), None


def replicated(t, slab):
    """``t``, a replicated tensor, as a slab op on ``slab`` reads it: its
    gradient is summed over the model group.  Identity without a slab or a
    gradient."""
    if slab is None or t is None or not _needs_grad(t):
        return t
    return _Copy.apply(t, slab.mesh)


def _halo(x, mesh, top, bottom):
    """``x`` with ``top`` rows of the rank above and ``bottom`` rows of the
    rank below, zeros past the plane's edges."""
    m, i = mesh.model, mesh.model_index
    n, c, r, w = x.shape
    up = x.new_zeros((n, c, top, w))
    down = x.new_zeros((n, c, bottom, w))
    sends, recvs = {}, {}
    if top and i + 1 < m:
        sends[i + 1] = x[:, :, r - top:]
    if bottom and i > 0:
        sends[i - 1] = x[:, :, :bottom]
    if top and i > 0:
        recvs[i - 1] = up
    if bottom and i + 1 < m:
        recvs[i + 1] = down
    mesh.exchange(sends, recvs)
    return torch.cat([up, x, down], dim=2)


def _halo_t(g, mesh, top, bottom):
    """The transpose of :func:`_halo`: the cotangent of the slab's rows,
    plus the neighbours' cotangents of the halo rows they took from it."""
    m, i = mesh.model, mesh.model_index
    n, c, t, w = g.shape
    r = t - top - bottom
    out = g[:, :, top:top + r].clone()
    sends, recvs = {}, {}
    if top and i > 0:
        sends[i - 1] = g[:, :, :top]
    if bottom and i + 1 < m:
        sends[i + 1] = g[:, :, top + r:]
    if top and i + 1 < m:
        recvs[i + 1] = g.new_empty((n, c, top, w))
    if bottom and i > 0:
        recvs[i - 1] = g.new_empty((n, c, bottom, w))
    mesh.exchange(sends, recvs)
    if i + 1 < m and top:
        out[:, :, r - top:] += recvs[i + 1]
    if i > 0 and bottom:
        out[:, :, :bottom] += recvs[i - 1]
    return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, top, bottom):
        ctx.args = (mesh, top, bottom)
        return _halo(x.contiguous(), mesh, top, bottom)

    @staticmethod
    def backward(ctx, g):
        return _HaloT.apply(g, *ctx.args), None, None, None


class _HaloT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, mesh, top, bottom):
        ctx.args = (mesh, top, bottom)
        return _halo_t(g.contiguous(), mesh, top, bottom)

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg, *ctx.args), None, None, None


@dataclass(frozen=True)
class Slab:
    """Rows ``[h0, h1)`` of a plane of ``H`` rows, held by this rank of
    ``mesh``'s model group, whose other ranks hold the rest."""
    h0: int
    h1: int
    H: int
    mesh: object

    @property
    def rows(self):
        return self.h1 - self.h0

    def scaled(self, res):
        """The same share of a plane of ``res`` rows (the rows a level's
        resampling op writes from this slab's)."""
        return Slab(self.h0 * res // self.H, self.h1 * res // self.H, res,
                    self.mesh)

    def halo(self, x, top, bottom):
        """Rows ``[h0 - top, h1 + bottom)`` of the plane from this slab
        ``x`` and its neighbours', zeros past the plane's edges
        (differentiable)."""
        if not (top or bottom):
            return x
        if max(top, bottom) > self.rows:
            raise ValueError(f"a halo of {top} / {bottom} rows beyond a slab "
                             f"of {self.rows}")
        if _needs_grad(x):
            return _Halo.apply(x, self.mesh, top, bottom)
        return _halo(x.contiguous(), self.mesh, top, bottom)

    def read(self, x, held, a, b):
        """Rows ``[a, b)`` of the plane that ``x`` holds, zeros outside it:
        ``held`` is the :class:`Slab` that ``x`` is (the rows beyond it come
        from the neighbours), or None for a whole (replicated) plane, whose
        rows this rank then takes."""
        if held is None:
            x = replicated(x, self)
            lo, hi = max(a, 0), min(b, x.shape[2])
            y = x[:, :, lo:hi]
            if lo - a or b - hi:
                y = F.pad(y, (0, 0, lo - a, b - hi))
            return y
        top, bottom = held.h0 - a, b - held.h1
        y = held.halo(x, max(top, 0), max(bottom, 0))
        if top < 0 or bottom < 0:
            y = y[:, :, max(-top, 0):y.shape[2] - max(-bottom, 0)]
        return y

    def take(self, x):
        """This slab's rows of a whole (replicated) plane."""
        return self.read(x, None, self.h0, self.h1)

    def gather(self, x):
        """The whole plane from this slab and the other ranks' (their sum
        over the model group, each rank's rows in zeros)."""
        x = F.pad(x, (0, 0, self.h0, self.H - self.h1))
        if _needs_grad(x):
            return _Sum.apply(x, self.mesh)
        return _sum_(x.contiguous(), self.mesh)
