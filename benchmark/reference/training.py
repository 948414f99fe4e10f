"""The plain reference of SH-GAN's training step (StyleGAN2's losses with
lazy regularization, as CoModGAN trains its inpainting generator), in
float32 PyTorch with TF32 off, over dicts of leaf tensors.

One step on a batch (real, mask):

* G phase: the non-saturating loss softplus(-D(G(x))) with style mixing,
  plus on every ``g_reg_interval``-th step the path-length penalty on the
  first N / ``pl_batch_shrink`` rows (its gradient a double backward),
  weighted by the interval; Adam with the lazy-regularization scaling
  r = I / (I + 1) of the LR and betas; ``w_avg`` chained through the
  phase's mapping passes;
* D phase: softplus(D(G(x))) + softplus(-D(real)), plus on every
  ``d_reg_interval``-th step R1 = gamma / 2 |dD(real)/d real|^2 (a double
  backward), weighted by the interval; Adam; the EMA of G.

Every random draw comes, in the step's fixed order, from a CPU
``torch.Generator`` seeded from (seed, step): the first z, the mixing
cutoff, its coin and the second z, the synthesis noise seed, the encoder's
dropout, the path-length noise.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import generator as g
from . import seeds

BUFFERS = ("noise_const", "w_avg")


def discriminator(P, d, x, taps):
    """StyleGAN2's residual D (CoModGAN: a 4-channel input): logits [N, 1]."""
    act = g.parse_act(d["activation"])
    R = d["resolution"]
    h, r = None, R
    while r > 4:
        p = f"b{r}"
        if r == R:
            h = g.conv_layer(x, P[f"{p}.fromrgb.weight"], P[f"{p}.fromrgb.bias"],
                             act)
        w = P[f"{p}.skip.weight"]
        y = g.upfirdn(h, taps, down=2, pad=(1, 1, 1, 1))
        y = F.conv2d(y, w * (1.0 / math.sqrt(w.shape[1]))) * math.sqrt(0.5)
        h = g.conv_layer(h, P[f"{p}.conv0.weight"], P[f"{p}.conv0.bias"], act)
        h = g.conv_layer(h, P[f"{p}.conv1.weight"], P[f"{p}.conv1.bias"], act,
                         down=2, taps=taps, gain=math.sqrt(0.5))
        h = y + h
        r //= 2
    n, c, hh, ww = h.shape
    k = min(d["mbstd_group_size"], n)
    f = d["mbstd_c_n"]
    y = h.reshape(k, -1, f, c // f, hh, ww)
    y = torch.sqrt((y - y.mean(dim=0)).square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4)).reshape(-1, f, 1, 1).repeat(k, 1, hh, ww)
    h = torch.cat([h, y], dim=1)
    h = g.conv_layer(h, P["b4.conv.weight"], P["b4.conv.bias"], act)
    h = g.dense(h.reshape(n, -1), P["b4.fc.weight"], P["b4.fc.bias"], act)
    return g.dense(h, P["b4.out.weight"], P["b4.out.bias"])


class Draws:
    """The step's random draws, in the order the step takes them."""

    def __init__(self, seed, step):
        self.gen = torch.Generator().manual_seed(
            seeds.derive_seed(seed, step, seeds.TRAIN_SALT))

    def randn(self, *shape):
        return torch.randn(shape, generator=self.gen)

    def rand(self, *shape):
        return torch.rand(shape, generator=self.gen)

    def randint(self, lo, hi):
        return int(torch.randint(lo, hi, (), generator=self.gen))


def _mapping(PG, model, z, w_avg):
    m = model["args"]["mapping"]["args"]
    x = g.mapping(PG, m, z)
    mean = x.detach().mean(dim=0)
    return x, mean + m["w_avg_beta"] * (w_avg - mean)


def _styles(PG, model, z, draws, prob, w_avg, dev):
    """ws [N, num_ws, w_dim] with style mixing, and the w_avg update."""
    num_ws = model["args"]["mapping"]["args"]["num_ws"]
    x, new_wa = _mapping(PG, model, z, w_avg)
    ws = x[:, None].repeat(1, num_ws, 1)
    cutoff = draws.randint(1, num_ws)
    if float(draws.rand()) >= prob:
        cutoff = num_ws
    z2 = draws.randn(*z.shape).to(dev)
    if cutoff < num_ws:
        w2 = g.mapping(PG, model["args"]["mapping"]["args"], z2)
        ws = torch.cat([ws[:, :cutoff], w2[:, None].repeat(
            1, num_ws - cutoff, 1)], dim=1)
    return ws, new_wa


def _encode(PG, model, x, draws, consts, dev):
    code, feats = g.encoder(PG, model["args"]["encoder"]["args"], x, consts)
    keep = (draws.rand(*code.shape) < 0.5).to(dev)
    return torch.where(keep, code * 2.0, torch.zeros_like(code)), feats


def run_g(PG, model, x, z, draws, prob, w_avg, consts, dev):
    ws, new_wa = _styles(PG, model, z, draws, prob, w_avg, dev)
    noise_seed = draws.randint(0, 2 ** 31 - 1)
    code, feats = _encode(PG, model, x, draws, consts, dev)
    img = g.synthesis(PG, model["args"]["synthesis"]["args"], code, feats, ws,
                      noise_seed, consts)
    return img, new_wa


class Adam:
    """PyTorch's Adam update, one tensor at a time."""

    def __init__(self, lr, betas, eps, r):
        self.lr = lr * r
        self.b1, self.b2 = (b ** r for b in betas)
        self.eps = eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, P, grads):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in P.items():
            gr = grads[k]
            m = self.m.get(k, torch.zeros_like(p))
            v = self.v.get(k, torch.zeros_like(p))
            m = m + (gr - m) * (1 - self.b1)
            v = v * self.b2 + gr * gr * (1 - self.b2)
            self.m[k], self.v[k] = m, v
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            P[k] = (p - (self.lr / bc1) * m / denom).detach()


def _grads(P, loss_terms):
    """d(sum of the terms)/dP, the NaN scrub applied (nan -> 0, inf ->
    +-1e5, no gradient -> 0)."""
    keys = list(P)
    total = {k: torch.zeros_like(P[k]) for k in keys}
    for loss in loss_terms:
        gs = torch.autograd.grad(loss, [P[k] for k in keys],
                                 allow_unused=True)
        for k, gr in zip(keys, gs):
            if gr is not None:
                total[k] = total[k] + gr
    return {k: torch.nan_to_num(v, nan=0.0, posinf=1e5, neginf=-1e5)
            for k, v in total.items()}


class Trainer:
    """The training state (G, D, G_ema, w_avg, pl_mean, both Adams) and
    its step."""

    def __init__(self, cfg, G_sd, D_sd, dev):
        self.cfg, self.dev = cfg, dev
        self.mg, self.md = cfg["model_g"], cfg["model_d"]
        lk = cfg["train"]["loss_kwargs"]
        self.lk = lk
        self.PG = {k: v.clone() for k, v in G_sd.items()
                   if k.split(".")[-1] not in BUFFERS}
        self.bufG = {k: v.clone() for k, v in G_sd.items()
                     if k.split(".")[-1] in BUFFERS}
        self.PD = {k: v.clone() for k, v in D_sd.items()}
        self.ema = {k: v.clone() for k, v in G_sd.items()}
        self.pl_mean = torch.zeros((), device=dev)
        opt = cfg["train"]["optimizer"]
        self.opt_g = Adam(opt["lr"], opt["betas"], opt["eps"],
                          lk["g_reg_interval"] / (lk["g_reg_interval"] + 1))
        self.opt_d = Adam(opt["lr"], opt["betas"], opt["eps"],
                          lk["d_reg_interval"] / (lk["d_reg_interval"] + 1))
        self.consts = g.constants(self.mg, dev)
        self.taps = g.fir_taps(self.md["args"]["resample_filter"], dev)
        self.step_i = 0
        self.first_grads = None

    def D(self, x):
        return discriminator(self.PD, self.md["args"], x, self.taps)

    def step(self, real, mask, seed):
        lk, dev, mg = self.lk, self.dev, self.mg
        n = real.shape[0]
        prob = lk["style_mixing_prob"]
        beta_w = mg["args"]["mapping"]["args"]["w_avg_beta"]
        draws = Draws(seed, self.step_i)
        greg = self.step_i % lk["g_reg_interval"] == 0
        dreg = self.step_i % lk["d_reg_interval"] == 0
        x_in = torch.cat([mask - 0.5, real * mask], dim=1)
        w0 = self.bufG["mapping.w_avg"]
        out = {}

        # G phase
        PG = {k: v.requires_grad_(True) for k, v in self.PG.items()}
        PD = {k: v.detach() for k, v in self.PD.items()}
        self.PD = PD
        z = draws.randn(n, mg["args"]["mapping"]["args"]["z_dim"]).to(dev)
        img, main_wa = run_g(PG, mg, x_in, z, draws, prob, w0, self.consts,
                             dev)
        loss_g = F.softplus(-self.D(torch.cat([mask - 0.5, img], 1))).mean()
        terms = [loss_g]
        out["loss_g"] = float(loss_g.detach())
        was = [main_wa]
        if greg:
            z2 = draws.randn(n, z.shape[1]).to(dev)
            k = max(n // lk["pl_batch_shrink"], 1)
            ws, pl_wa = _styles(PG, mg, z2[:k], draws, prob, w0, dev)
            code, feats = _encode(PG, mg, x_in[:k], draws, self.consts, dev)
            nseed = draws.randint(0, 2 ** 31 - 1)
            res = mg["args"]["synthesis"]["args"]["resolution"]
            rgb = mg["args"]["synthesis"]["args"]["rgb_n"]
            pl_noise = draws.randn(k, rgb, res, res).to(dev) / math.sqrt(
                res * res)
            img = g.synthesis(PG, mg["args"]["synthesis"]["args"], code, feats,
                              ws, nseed, self.consts)
            pl_grads, = torch.autograd.grad((img * pl_noise).sum(), ws,
                                            create_graph=True)
            pl_len = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
            pl_mean = self.pl_mean + lk["pl_decay"] * (pl_len.mean()
                                                       - self.pl_mean)
            loss_pl = ((pl_len - pl_mean).square() * lk["pl_weight"]).mean()
            terms.append(loss_pl * lk["g_reg_interval"])
            out["pl_lengths"] = float(pl_len.detach().mean())
            self.pl_mean = pl_mean.detach()
            was.append(pl_wa)
        gG = _grads(PG, terms)
        self.opt_g.step(self.PG, gG)
        wa = w0
        for a in was:
            wa = a + beta_w * (wa - w0)
        self.bufG["mapping.w_avg"] = wa.detach()

        # D phase
        w0d = self.bufG["mapping.w_avg"]
        PD = {k: v.requires_grad_(True) for k, v in self.PD.items()}
        PG = {k: v.detach() for k, v in self.PG.items()}
        z3 = draws.randn(n, z.shape[1]).to(dev)
        with torch.no_grad():
            img, d_wa = run_g(PG, mg, x_in, z3, draws, prob, w0d, self.consts,
                              dev)
        gen_l = self.D(torch.cat([mask - 0.5, img], 1))
        real_l = self.D(torch.cat([mask - 0.5, real], 1))
        loss_d = (F.softplus(gen_l) + F.softplus(-real_l)).mean()
        terms = [loss_d]
        out["loss_d"] = float(loss_d.detach())
        if dreg:
            real_in = real.detach().requires_grad_(True)
            logits = self.D(torch.cat([mask - 0.5, real_in], 1))
            r1g, = torch.autograd.grad(logits.sum(), real_in, create_graph=True)
            pen = r1g.square().sum(dim=(1, 2, 3))
            terms.append((pen * (lk["r1_gamma"] / 2)).mean()
                         * lk["d_reg_interval"])
            out["r1_penalty"] = float(pen.detach().mean())
        gD = _grads(PD, terms)
        self.opt_d.step(self.PD, gD)
        self.bufG["mapping.w_avg"] = (d_wa + beta_w * (w0d - w0d)).detach()
        if self.first_grads is None:
            self.first_grads = {**{"G." + k: v for k, v in gG.items()},
                                **{"D." + k: v for k, v in gD.items()}}
        ema_beta = 0.5 ** (n / max(lk["ema_kimg"] * 1000, 1e-8))
        with torch.no_grad():
            for k in self.ema:
                if k in self.PG:
                    self.ema[k] = self.PG[k] + ema_beta * (self.ema[k]
                                                           - self.PG[k])
                else:
                    self.ema[k] = self.bufG[k].clone()
        self.step_i += 1
        return out

    def state(self):
        """{"G.<name>" / "D.<name>" / "G_ema.<name>": tensor}."""
        return {**{"G." + k: v for k, v in self.PG.items()},
                **{"G." + k: v for k, v in self.bufG.items()},
                **{"D." + k: v for k, v in self.PD.items()},
                **{"G_ema." + k: v for k, v in self.ema.items()}}
