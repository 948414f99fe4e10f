"""The training step: Gmain [+ Gpl] then Dmain [+ R1], two optimizers
with lazy-regularization scaling (Adam by default, or one of the registry
of :mod:`.schedules`, with an optional LR schedule), the NaN scrub, G-EMA
(port of ``shgan_tpu/train/step.py:45-362``), on one device or on each rank
of a data-parallel :class:`~shgan_torch.parallel.Mesh`.

  * every step:        Gmain + Dmain
  * g_reg_interval:    + Gpl (path length), loss scaled by the interval
  * d_reg_interval:    + R1, loss scaled by the interval

Each phase runs its own backward (their gradients add up as the JAX step's
one gradient of the summed loss does) and a phase's frozen network keeps
``requires_grad`` off, so the G phase computes no D gradients and the D
phase none of G.  ``noise_const`` and ``w_avg`` are buffers: the optimizer
never sees them and the EMA copies them.  ``w_avg`` chains through Gmain ->
Gpl -> Dmain as in the JAX step (``step.py:186-198, 232-268, 300-308``),
grad-accumulation rounds included.

Across ranks each rank holds its rows of the global batch (of each
accumulation round), the losses read the global batch's statistics
(:mod:`.loss`) and each network's gradients are averaged over the ranks in
one flat buffer before the NaN scrub and the optimizer, so every rank
applies the same update and the replicas stay equal bit for bit.  Not
``DistributedDataParallel``: R1 and the path-length penalty take
``torch.autograd.grad(create_graph=True)``, which DDP does not support.
The step runs inside a ``train.step`` span and each phase inside one
named after it (``Gmain``, ``Gpl``, ``Dmain``, ``R1``, ``opt_ema``;
``runtime/tracing.span``), so a profiler trace splits a step by phase.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..runtime.tracing import span
from . import loss as L
from .schedules import get_optimizer, get_scheduler

# the JAX step's _BUFFER_NAMES: the EMA copies them, the optimizer skips them
BUFFER_NAMES = ("noise_const", "w_avg")


@dataclass
class TrainConfig:
    style_mixing_prob: float = 0.9
    r1_gamma: float = 10.0
    pl_weight: float = 2.0
    pl_decay: float = 0.01
    pl_batch_shrink: int = 2
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    g_opt: dict = field(default_factory=lambda: dict(lr=0.002,
                                                     betas=(0.0, 0.99)))
    d_opt: dict = field(default_factory=lambda: dict(lr=0.002,
                                                     betas=(0.0, 0.99)))
    # micro-batch rounds per optimizer step, gradients averaged
    grad_accum: int = 1
    ema_kimg: float = 10.0
    ema_rampup: float | None = None


def freeze_buffers(module):
    """The parameters the optimizer updates: every parameter of ``module``
    but the buffer names (which the port registers as buffers anyway)."""
    return [p for name, p in module.named_parameters()
            if name.split(".")[-1] not in BUFFER_NAMES]


def make_optimizer(params, lr=0.002, betas=(0.0, 0.99), eps=1e-8,
                   reg_interval=None, optimizer=None, schedule=None):
    """The optimizer of one network, with lazy-regularization scaling
    ``r = I / (I + 1)`` (JAX ``step.py:74-111``).

    The LR of update ``k`` (``opt.lr_at(k)``, optax's count: 0 at the first
    update) is ``lr * r``, or with ``schedule`` (a list of ``{"type",
    "args"}`` segments; ``lr`` is then ignored) ``schedule(k) * r`` in
    float32.  ``optimizer`` (``{"type", "args"}``) picks one of the
    registry of :mod:`.schedules` with its own args as they are; without
    it, Adam with ``betas ** r``.  PyTorch's Adam divides by ``sqrt(v_hat)
    + eps`` as optax's ``scale_by_adam`` does."""
    r = 1.0
    if reg_interval is not None:
        r = reg_interval / (reg_interval + 1)
    if schedule is not None:
        base, r32 = get_scheduler(schedule), np.float32(r)
        lr_at = lambda count: base(count) * r32  # noqa: E731
    else:
        lr_at = lr * r
    if optimizer is not None:
        return get_optimizer(optimizer, params, lr_at)
    return get_optimizer(
        {"type": "adam", "args": {
            "betas": tuple(float(b) ** r for b in betas), "eps": eps}},
        params, lr_at)


def optimizer_step(opt, count):
    """Update ``count`` of ``opt``: every param group's LR set to
    ``opt.lr_at(count)``, then ``opt.step()``."""
    lr = opt.lr_at(count)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


@torch.no_grad()
def nan_scrub(params):
    """The pre-step scrub (nan -> 0, +-inf -> +-1e5) of every gradient, in
    place; a parameter without a gradient gets zeros, so Adam's moments
    decay for it as optax's do."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=1e5, neginf=-1e5)


@torch.no_grad()
def ema_update(G_ema, G, ema_beta):
    """p_ema = p + beta * (p_ema - p), as three multi-tensor ops over all
    parameters; buffers copied."""
    pe, p = list(G_ema.parameters()), list(G.parameters())
    torch._foreach_sub_(pe, p)
    torch._foreach_mul_(pe, ema_beta)
    torch._foreach_add_(pe, p)
    for be, b in zip(G_ema.buffers(), G.buffers()):
        be.copy_(b)


def compute_ema_beta(cfg, batch_size, cur_nimg):
    """EMA beta with the optional ramp-up."""
    ema_nimg = cfg.ema_kimg * 1000
    if cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * cfg.ema_rampup)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


class TrainStep:
    """The state (G, D, G_ema, both optimizers, ``pl_mean``, ``step``) and
    the step over it.  ``step`` counts the steps taken, one update of each
    optimizer a step, so it is both optimizers' update count: update
    ``step`` runs at ``opt.lr_at(step)``, and a resumed state carries it.
    ``mesh``: the ranks (None: one device); the step then takes this rank's
    rows of its data group and the draws ``given`` hold the global batch's.
    With a model axis, G's sharded levels run on slabs where
    :func:`~shgan_torch.parallel.spatial_sharding` is active around the
    step."""

    PHASES = ("Gmain", "Gpl", "Dmain", "R1", "opt_ema")

    def __init__(self, G, D, cfg, G_ema=None, mesh=None):
        self.G, self.D, self.cfg = G, D, cfg
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.G_ema = (G_ema if G_ema is not None
                      else copy.deepcopy(G)).requires_grad_(False)
        self.opt_g = make_optimizer(freeze_buffers(G), **cfg.g_opt,
                                    reg_interval=cfg.g_reg_interval)
        self.opt_d = make_optimizer(freeze_buffers(D), **cfg.d_opt,
                                    reg_interval=cfg.d_reg_interval)
        dev = next(G.parameters()).device
        self.pl_mean = torch.zeros((), device=dev)
        self.step = 0
        beta = getattr(G.mapping, "w_avg_beta", None)
        self.w_beta = beta if getattr(G.mapping, "w_avg", None) is not None \
            else None

    def _draw(self, given, name, r, nm, shape, gen, device, rows=None):
        """Round ``r``'s ``nm`` rows of a per-row draw (given, or from
        ``gen``), or this rank's ``rows`` of the round's global draw."""
        if given is not None and name in given:
            z = given[name][r * nm:(r + 1) * nm]
        else:
            z = L.randn((nm,) + tuple(shape), gen, device)
        return (z if rows is None else rows.take(z)).to(device)

    def __call__(self, real, mask, gen, ema_beta, do_greg, do_dreg,
                 given=None):
        """One step on ``(real [N,3,H,W], mask [N,1,H,W])``; returns the
        metrics as 0-dim tensors on the device (no host readback).
        ``given`` may hold the draws ``z1``, ``z2``, ``z3`` ([N, z_dim]) and
        ``pl_noise`` as tensors.  With a mesh, ``real`` and ``mask`` hold
        this rank's rows of each round's global batch, in round order, and
        ``N`` counts the global batch."""
        with span("train.step"):
            return self._step(real, mask, gen, ema_beta, do_greg, do_dreg,
                              given)

    def _step(self, real, mask, gen, ema_beta, do_greg, do_dreg, given):
        G, D, cfg, mesh = self.G, self.D, self.cfg, self.mesh
        real = real.float()
        mask = mask.float()
        x_in = torch.cat([mask - 0.5, real * mask], dim=1)
        n = real.shape[0]
        A = max(int(cfg.grad_accum), 1)
        if n % A:
            raise ValueError(f"batch {n} is not a multiple of grad_accum {A}")
        nm = n // A
        # the global rows of a round, and this rank's of them
        nmg = nm * (mesh.data if mesh is not None else 1)
        rows = mesh.rows(nmg) if mesh is not None else None
        dev = real.device
        zs = (G.z_dim,)

        # ----- G phase: Gmain [+ Gpl] -----
        D.requires_grad_(False)
        G.requires_grad_(True)
        w0 = G.mapping.w_avg.clone() if self.w_beta is not None else None
        mains, scores, main_was, pl_was, pl_lens = [], [], [], [], []
        pl_mean = self.pl_mean
        for r in range(A):
            sl = slice(r * nm, (r + 1) * nm)
            with span("Gmain"):
                z = self._draw(given, "z1", r, nmg, zs, gen, dev, rows)
                loss, aux = L.g_main_loss(G, D, x_in[sl], mask[sl], z, gen,
                                          cfg.style_mixing_prob, rows=rows)
                (loss / A).backward()
            mains.append(loss.detach())
            scores.append(aux["scores_fake"])
            main_was.append(aux["w_avg"])
            if do_greg:
                with span("Gpl"):
                    # the round's global rows: the penalty takes the first
                    # N / pl_batch_shrink of them, split over the ranks
                    z2 = self._draw(given, "z2", r, nmg, zs, gen, dev)
                    x_pl = x_in[sl] if rows is None else rows.gather(
                        x_in[sl])
                    pl_noise = None
                    if given is not None and "pl_noise" in given:
                        k = max(nmg // cfg.pl_batch_shrink, 1)
                        pl_noise = given["pl_noise"][
                            r * k:(r + 1) * k].to(dev)
                    loss_pl, pl_mean, pl_len, pl_wa = L.g_pl_loss(
                        G, x_pl, z2, gen, pl_mean,
                        pl_decay=cfg.pl_decay, pl_weight=cfg.pl_weight,
                        pl_batch_shrink=cfg.pl_batch_shrink,
                        style_mixing_prob=cfg.style_mixing_prob,
                        pl_noise=pl_noise, mesh=mesh)
                    (loss_pl * (cfg.g_reg_interval / A)).backward()
                pl_lens.append(pl_len)
                pl_was.append(pl_wa)
        if mesh is not None:
            # one path-length mean on the ranks of a model group
            pl_mean = mesh.model_mean(pl_mean)
        with span("opt_ema"):
            if mesh is not None:
                mesh.average_grads(freeze_buffers(G))
            nan_scrub(freeze_buffers(G))
            optimizer_step(self.opt_g, self.step)
            self.opt_g.zero_grad(set_to_none=True)
            if self.w_beta is not None:
                # all Gmain rounds fold first, then the Gpl rounds, each a
                # lerp from the stale pre-step w0
                wa = w0
                for aux_wa in main_was + pl_was:
                    wa = aux_wa + self.w_beta * (wa - w0)
                G.mapping.w_avg.copy_(wa)
        metrics = {"loss_g": torch.stack(mains).mean(),
                   "pl_mean": pl_mean,
                   "pl_lengths": (torch.stack(pl_lens).mean() if pl_lens
                                  else torch.zeros((), device=dev)),
                   "scores_fake_g": torch.stack(scores).mean()}

        # ----- D phase: Dmain [+ R1] -----
        G.requires_grad_(False)
        D.requires_grad_(True)
        w0d = G.mapping.w_avg.clone() if self.w_beta is not None else None
        wad = w0d
        d_mains, s_real, s_fake, r1s = [], [], [], []
        for r in range(A):
            sl = slice(r * nm, (r + 1) * nm)
            with span("Dmain"):
                z = self._draw(given, "z3", r, nmg, zs, gen, dev, rows)
                loss, aux = L.d_main_loss(G, D, x_in[sl], mask[sl], real[sl],
                                          z, gen, cfg.style_mixing_prob,
                                          rows=rows)
                (loss / A).backward()
            d_mains.append(loss.detach())
            s_real.append(aux["scores_real"])
            s_fake.append(aux["scores_fake"])
            if self.w_beta is not None:
                wad = aux["w_avg"] + self.w_beta * (wad - w0d)
            if do_dreg:
                with span("R1"):
                    loss_r1, r1 = L.d_r1_loss(D, mask[sl], real[sl],
                                              r1_gamma=cfg.r1_gamma,
                                              rows=rows)
                    (loss_r1 * (cfg.d_reg_interval / A)).backward()
                r1s.append(r1)
        with span("opt_ema"):
            if mesh is not None:
                mesh.average_grads(freeze_buffers(D))
            nan_scrub(freeze_buffers(D))
            optimizer_step(self.opt_d, self.step)
            self.opt_d.zero_grad(set_to_none=True)
            G.requires_grad_(True)
            if self.w_beta is not None:
                G.mapping.w_avg.copy_(wad)
            ema_update(self.G_ema, G, ema_beta)
        self.pl_mean = pl_mean
        self.step += 1
        metrics.update(
            loss_d=torch.stack(d_mains).mean(),
            r1_penalty=(torch.stack(r1s).mean() if r1s
                        else torch.zeros((), device=dev)),
            scores_real=torch.stack(s_real).mean(),
            scores_fake_d=torch.stack(s_fake).mean())
        return metrics
