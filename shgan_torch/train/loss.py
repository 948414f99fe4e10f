"""StyleGAN2 GAN losses for conditional inpainting (port of
``shgan_tpu/train/loss.py:30-171``): the non-saturating softplus loss with
style mixing, the path-length penalty (a second derivative through the
synthesis network: kernel K2's backward and the epilogue's grad kernel,
each differentiated once more) and the R1 penalty on real images (K2's
second order through the discriminator), and the plain StyleGAN2 G loss of
the unconditional family (:func:`unconditional_g_main_loss`).

G is conditioned on ``x = cat([mask - 0.5, real * mask])`` and D sees
``cat([mask - 0.5, img])``.  Every random draw comes, in a fixed order, from
the ``torch.Generator`` passed in (z's second draw and the mixing cutoff,
the encoder's dropout mask, the synthesis noise seed, the path-length
noise), so a run is a function of the generator's seed; a caller may give
``pl_noise`` as a tensor instead.  ``w_avg`` and ``pl_mean`` updates are
returned, not applied: the train step chains them.

Across ranks (``rows``: this rank's :class:`~shgan_torch.parallel.Rows` of
the global batch) every per-row draw is drawn at the global batch's shape
and cut to the rank's rows, the scalar draws are shared, the noise's rows
start at the rank's offset, and the batch means (``w_avg``, ``pl_mean``,
the style normalization, the minibatch stddev) are taken over the global
batch: a W-rank step draws and computes what one device does on the whole
batch.  Each rank's loss is its rows' mean (the path-length loss: the
global one); the train step averages the gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SEED_HIGH = 2 ** 31 - 1


def randn(shape, gen, device):
    """N(0, 1) drawn from ``gen`` (on its device), moved to ``device``."""
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def noise_seed(gen):
    """A synthesis noise seed drawn from ``gen``."""
    return int(torch.randint(0, _SEED_HIGH, (), generator=gen,
                             device=gen.device))


def draw_rows(fn, shape, rows):
    """``fn(shape)``, or this rank's rows of it at the global batch's
    shape."""
    return fn(tuple(shape)) if rows is None else rows.draw(fn, shape)


def mixing_draws(num_ws, z, gen, style_mixing_prob, rows=None):
    """(cutoff, z2): the mixing cutoff, ``num_ws`` (no mixing) with
    probability ``1 - style_mixing_prob``, and the second z."""
    cutoff = int(torch.randint(1, num_ws, (), generator=gen,
                               device=gen.device))
    if float(torch.rand((), generator=gen, device=gen.device)) \
            >= style_mixing_prob:
        cutoff = num_ws
    return cutoff, draw_rows(lambda s: randn(s, gen, z.device), z.shape,
                             rows)


def style_mix(G, ws, z, gen, style_mixing_prob, c=None, mix=None,
              rows=None):
    """With probability ``style_mixing_prob`` the styles from a random
    cutoff on come from a second z (``shgan_tpu/train/loss.py:40-49``);
    ``mix`` gives ``(cutoff, z2)`` instead of drawing them."""
    if style_mixing_prob <= 0:
        return ws
    num_ws = ws.shape[1]
    cutoff, z2 = mix if mix is not None else mixing_draws(
        num_ws, z, gen, style_mixing_prob, rows)
    if cutoff == num_ws:
        return ws
    return torch.cat([ws[:, :cutoff], G.mapping(z2, c)[:, cutoff:]], dim=1)


def run_g(G, x_in, z, gen, style_mixing_prob=0.9, update_w_avg=True,
          train=True, rows=None):
    """Generator forward with style mixing; returns (img, ws, new_w_avg)."""
    if update_w_avg:
        ws, new_w_avg = G.mapping(z, update_w_avg=True, rows=rows)
    else:
        ws, new_w_avg = G.mapping(z), None
    ws = style_mix(G, ws, z, gen, style_mixing_prob, rows=rows)
    img = G.forward_ws(x_in, ws, noise_mode="random",
                       noise_seed=noise_seed(gen), train=train,
                       generator=gen, row0=_row0(rows), rows=rows)
    return img, ws, new_w_avg


def _row0(rows):
    return 0 if rows is None else rows.start


def g_main_loss(G, D, x_in, mask, z, gen, style_mixing_prob=0.9, rows=None):
    """Non-saturating generator loss softplus(-D(G(x)))."""
    img, _ws, new_w_avg = run_g(G, x_in, z, gen, style_mixing_prob,
                                rows=rows)
    logits = D(torch.cat([mask - 0.5, img], dim=1), rows=rows)
    loss = F.softplus(-logits).mean()
    return loss, {"w_avg": new_w_avg, "scores_fake": logits.detach().mean()}


def g_pl_loss(G, x_in, z, gen, pl_mean, pl_decay=0.01, pl_weight=2.0,
              pl_batch_shrink=2, style_mixing_prob=0.9, pl_noise=None,
              mesh=None):
    """Path-length penalty on the first ``N // pl_batch_shrink`` rows.

    Returns ``(loss, new_pl_mean, pl_lengths_mean, new_w_avg)``.  The penalty
    differentiates through the lerped ``pl_mean`` (``loss.py:110-116``).
    With a ``mesh`` of several ranks, ``x_in``, ``z`` and a given
    ``pl_noise`` are the global batch's and the penalty's rows are split
    over the ranks in equal blocks; the loss is the global one on every
    rank."""
    n = max(x_in.shape[0] // pl_batch_shrink, 1)
    rows = None if mesh is None else mesh.rows(n)
    x_s, z_s = x_in[:n], z[:n]
    if rows is not None:
        x_s, z_s = rows.take(x_s), rows.take(z_s)
        if pl_noise is not None:
            pl_noise = rows.take(pl_noise)
    ws, new_w_avg = G.mapping(z_s, update_w_avg=True, rows=rows)
    ws = style_mix(G, ws, z_s, gen, style_mixing_prob, rows=rows)
    x_global, feats = G.encoder(x_s, train=True, generator=gen, rows=rows)
    seed = noise_seed(gen)
    res, rgb_n = G.synthesis.resolution, G.synthesis.rgb_n
    if pl_noise is None:
        pl_noise = draw_rows(lambda s: randn(s, gen, x_in.device),
                             (n, rgb_n, res, res), rows) / math.sqrt(res * res)
    img = G.synthesis(x_global, feats, ws, noise_mode="random",
                      noise_seed=seed, row0=_row0(rows), rows=rows)
    pl_grads, = torch.autograd.grad((img * pl_noise).sum(), ws,
                                    create_graph=True)
    pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    if rows is not None:
        pl_lengths = rows.gather(pl_lengths)
    new_pl_mean = pl_mean + pl_decay * (pl_lengths.mean() - pl_mean)
    loss = ((pl_lengths - new_pl_mean).square() * pl_weight).mean()
    return (loss, new_pl_mean.detach(), pl_lengths.detach().mean(),
            new_w_avg)


def d_main_loss(G, D, x_in, mask, real, z, gen, style_mixing_prob=0.9,
                rows=None):
    """softplus(D(G(x))) + softplus(-D(real)); G runs without a gradient,
    its mapping forward still advances w_avg."""
    with torch.no_grad():
        img, _ws, new_w_avg = run_g(G, x_in, z, gen, style_mixing_prob,
                                    rows=rows)
    gen_logits = D(torch.cat([mask - 0.5, img], dim=1), rows=rows)
    real_logits = D(torch.cat([mask - 0.5, real], dim=1), rows=rows)
    loss = (F.softplus(gen_logits) + F.softplus(-real_logits)).mean()
    return loss, {"scores_fake": gen_logits.detach().mean(),
                  "scores_real": real_logits.detach().mean(),
                  "w_avg": new_w_avg}


def d_r1_loss(D, mask, real, r1_gamma=10.0, rows=None):
    """R1: gamma/2 * |dD(real)/d real|^2, the gradient w.r.t. the real RGB
    only.  Returns ``(loss, r1_penalty_mean)``.  Across ranks the gradient
    is the global logits' sum's (the minibatch stddev couples the rows)."""
    real_in = real.detach().requires_grad_(True)
    logits = D(torch.cat([mask - 0.5, real_in], dim=1), rows=rows)
    r1_grads, = torch.autograd.grad(logits.sum(), real_in, create_graph=True)
    r1_penalty = r1_grads.square().sum(dim=(1, 2, 3))
    return (r1_penalty * (r1_gamma / 2)).mean(), r1_penalty.detach().mean()


def unconditional_g_main_loss(G, D, z, c, gen, style_mixing_prob=0.9,
                              mix=None):
    """The plain StyleGAN2 G loss softplus(-D(G(z))) of the unconditional
    family (``shgan_tpu/train/loss.py:153-171``), with style mixing and
    random synthesis noise; ``mix`` may give the mixing ``(cutoff, z2)``.
    Returns ``(loss, {"w_avg": new w_avg})``."""
    ws, new_w_avg = G.mapping(z, c, update_w_avg=True)
    ws = style_mix(G, ws, z, gen, style_mixing_prob, c, mix)
    img = G.synthesis(ws, noise_mode="random", noise_seed=noise_seed(gen))
    logits = D(img, c)
    return F.softplus(-logits).mean(), {"w_avg": new_w_avg}
