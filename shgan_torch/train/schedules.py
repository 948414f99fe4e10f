"""Composable learning-rate schedules and the optimizer registry (port of
``shgan_tpu/train/schedules.py``).

A schedule is a pipeline of segments, each ``{"type", "args"}``::

    [{"type": "linear",   "args": {"start_lr": 1e-3, "end_lr": 1e-4,
                                   "step": 1000}},
     {"type": "constant", "args": {"lr": 1e-4, "step": 9000}}]

:class:`ComposedSchedule` indexes it two ways, as the JAX package does:
``schedule[i]`` is the float64 closed form and raises past the end;
``schedule(count)`` is the value the optimizer uses, computed in float32
as JAX's traced schedule computes it, and clamps past the end.  An
optimizer from :func:`get_optimizer` is a ``torch.optim`` optimizer; its
``lr_at(count)`` gives the LR of update ``count`` (0 at the first update,
optax's count), which the train step writes into every param group just
before ``step()``.
"""

from __future__ import annotations

import numpy as np
import torch

_SCHEDULERS = {}
_OPTIMIZERS = {}

f32 = np.float32


def register_scheduler(name):
    def wrapper(fn):
        _SCHEDULERS[name] = fn
        return fn
    return wrapper


def register_optimizer(name):
    def wrapper(fn):
        _OPTIMIZERS[name] = fn
        return fn
    return wrapper


class Segment:
    """A schedule segment of ``step`` indices: ``lr_at(i)`` in float64 and
    ``lr32_at(i)`` in float32, valid for ``0 <= i < step``."""

    def __init__(self, step, lr_at, lr32_at):
        self.step = int(step)
        self._lr_at = lr_at
        self._lr32_at = lr32_at

    def __getitem__(self, idx):
        if idx >= self.step:
            raise ValueError(idx)
        return float(self._lr_at(idx))

    def to_list(self):
        return [self[i] for i in range(self.step)]


@register_scheduler("constant")
def constant_scheduler(lr, step):
    return Segment(step, lambda i: lr, lambda i: f32(lr))


def _frac32(i, step):
    """``1 - i / step`` as JAX computes it on a traced int32 index: the
    division in float32, then the subtraction in float32."""
    return f32(1) - f32(i) / f32(step)


@register_scheduler("poly")
def poly_scheduler(start_lr, end_lr, power, step):
    return Segment(
        step,
        lambda i: end_lr + (start_lr - end_lr) * (1 - i / step) ** power,
        lambda i: f32(end_lr) + f32(start_lr - end_lr)
        * f32(_frac32(i, step) ** f32(power)))


@register_scheduler("linear")
def linear_scheduler(start_lr, end_lr, step):
    return Segment(
        step, lambda i: end_lr + (start_lr - end_lr) * (1 - i / step),
        lambda i: f32(end_lr) + f32(start_lr - end_lr) * _frac32(i, step))


@register_scheduler("multistage")
def multistage_scheduler(start_lr, milestones, gamma, step):
    # constant until each milestone, then ×gamma; the float32 value is the
    # float64 one rounded (JAX gathers it from a float32 table)
    bounds = np.asarray([0] + list(milestones), dtype=np.int64)

    def lr_at(i):
        stage = int(np.searchsorted(bounds, i, side="right") - 1)
        return start_lr * (gamma ** stage)

    return Segment(step, lr_at, lambda i: f32(lr_at(i)))


class ComposedSchedule:
    """The concatenation of segments: ``[i]`` (float64, raises past the
    end) and ``(count)`` (float32, clamps to the last index)."""

    def __init__(self, segments):
        assert segments
        self.segments = list(segments)
        self.boundaries = np.cumsum([s.step for s in self.segments])
        self.step = int(self.boundaries[-1])

    def _locate(self, idx):
        for seg, end in zip(self.segments, self.boundaries):
            if idx < end:
                return seg, idx - (int(end) - seg.step)
        raise ValueError(idx)

    def __getitem__(self, idx):
        if idx >= self.step:
            raise ValueError(idx)
        seg, local = self._locate(idx)
        return seg[local]

    def to_list(self):
        out = []
        for seg in self.segments:
            out.extend(seg.to_list())
        return out

    def __call__(self, count):
        seg, local = self._locate(min(max(int(count), 0), self.step - 1))
        return f32(seg._lr32_at(local))


def get_scheduler(pipeline_cfg):
    """A :class:`ComposedSchedule` from a list of ``{"type", "args"}``."""
    segments = []
    for ci in pipeline_cfg:
        segments.append(_SCHEDULERS[ci["type"]](**ci["args"]))
    if not segments:
        raise ValueError("empty scheduler pipeline")
    return ComposedSchedule(segments)


# optax's add_decayed_weights chained before adam or sgd adds wd·p to the
# gradient before the moments: torch's ``weight_decay`` (not AdamW)


@register_optimizer("adam")
def _adam(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


@register_optimizer("sgd")
def _sgd(params, lr, momentum=0.0, weight_decay=0.0, nesterov=False):
    # optax.sgd(momentum=0) keeps no trace, so Nesterov needs a momentum;
    # both packages' Nesterov step is g + μ·t_new
    return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0,
                           weight_decay=weight_decay,
                           nesterov=bool(nesterov and momentum))


def get_optimizer(cfg, params, learning_rate):
    """A ``torch.optim`` optimizer over ``params`` from ``{"type",
    "args"}``.  ``learning_rate``: a float, or a function of the update
    count (e.g. a :func:`get_scheduler` schedule); the optimizer's
    ``lr_at(count)`` returns it as a float."""
    lr_at = (learning_rate if callable(learning_rate)
             else lambda count: learning_rate)
    opt = _OPTIMIZERS[cfg["type"]](params, float(lr_at(0)),
                                   **dict(cfg.get("args") or {}))
    opt.lr_at = lambda count: float(lr_at(count))
    return opt
