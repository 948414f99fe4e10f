"""The port's training losses, optimizer, EMA and train step against
shgan_tpu on the CPU, on a tiny G + D (the models of tests/test_train.py at
32²).

Weights are carried from the JAX parameter trees by ``params_from_jax``.
Style mixing, the encoder's dropout and every ``noise_strength`` are off,
so the random draws that differ by design (the noise streams,
``ops/noise.py``) drop out; the draws that remain (z, the path-length
noise) are made with JAX's keys here and handed to the port.
``noise_strength`` gradients are left out of the comparison: they are sums
of the layer's noise.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import (params_to_flat_state_dict,
                                  torch_state_dict_to_params)
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.train import loss as JL
from shgan_tpu.train import step as JS
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.models import get_model
from shgan_torch.train import loss as TL
from shgan_torch.train import step as TS
from test_torch_models import tiny_cfg
from test_torch_train_ops import tiny_d_cfg

RES = 32
N = 4
BUFFERS = ("noise_const", "w_avg")


def _g_cfg():
    cfg = copy.deepcopy(tiny_cfg(RES))
    cfg["args"]["encoder"]["args"]["use_dropout"] = False
    return cfg


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            params_to_flat_state_dict(tree).items()}


def _with_biases(flat, seed):
    """Random biases (zero-initialised ones would hide the bias paths);
    every noise_strength stays 0."""
    rng = np.random.RandomState(seed)
    return {k: ((v + rng.randn(*v.shape) * 0.1) if k.endswith(".bias")
                else v).astype(np.float32) for k, v in flat.items()}


@pytest.fixture(scope="module")
def models():
    jg, jd = jax_get_model(_g_cfg()), jax_get_model(tiny_d_cfg(RES))
    fg = _with_biases(_flat(jg.init(jax.random.key(0))), 1)
    fd = _with_biases(_flat(jd.init(jax.random.key(1))), 2)
    return jg, jd, fg, fd


def _port(models):
    jg, jd, fg, fd = models
    G, D = get_model(_g_cfg()), get_model(tiny_d_cfg(RES))
    G.load_state_dict(params_from_jax(fg), strict=True)
    D.load_state_dict(params_from_jax(fd), strict=True)
    return G, D


def _batch(seed=0, n=N):
    rng = np.random.RandomState(seed)
    real = rng.randn(n, 3, RES, RES).astype(np.float32)
    mask = (rng.rand(n, 1, RES, RES) > 0.4).astype(np.float32)
    x_in = np.concatenate([mask - 0.5, real * mask], axis=1)
    z = rng.randn(n, 32).astype(np.float32)
    return real, mask, x_in, z


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close_rel(got, want, rtol=1e-4, what=""):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-6), (what, got, want)


def _check_grads(module, want_tree, what):
    """Each gradient leaf within 1e-3 * max|g| + 1e-6."""
    want = _flat(want_tree)
    seen = 0
    for name, p in module.named_parameters():
        if name.endswith("noise_strength"):
            continue
        w = want[name]
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        tol = 1e-3 * float(np.abs(w).max()) + 1e-6
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} {name}: err {err} > {tol}"
        seen += 1
    assert seen > 10


def test_discriminator_carried_by_params_from_jax(models):
    """params_from_jax flattens the discriminator's tree: every name, every
    shape, strict."""
    _, jd, _, fd = models
    D = get_model(tiny_d_cfg(RES))
    sd = params_from_jax(torch_state_dict_to_params(fd))
    assert set(sd) == set(D.state_dict())
    D.load_state_dict(sd, strict=True)


def test_g_main_loss_and_gradient_match_jax(models):
    jg, jd, fg, fd = models
    real, mask, x_in, z = _batch(0)
    pg, pd = torch_state_dict_to_params(fg), torch_state_dict_to_params(fd)
    c = jnp.zeros((N, 0))

    def f(pg):
        return JL.g_main_loss(jg, jd, pg, pd, jnp.asarray(x_in),
                              jnp.asarray(mask), jnp.asarray(z), c,
                              jax.random.key(3), style_mixing_prob=0.0)
    (want, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(pg)
    G, D = _port(models)
    D.requires_grad_(False)
    loss, taux = TL.g_main_loss(G, D, _t(x_in), _t(mask), _t(z),
                                torch.Generator().manual_seed(0), 0.0)
    loss.backward()
    _close_rel(loss, want, what="loss")
    _close_rel(taux["scores_fake"], aux["scores_fake"], 1e-4, "scores")
    np.testing.assert_allclose(taux["w_avg"].numpy(), aux["w_avg"],
                               rtol=1e-5, atol=1e-6)
    _check_grads(G, grads, "G")


def test_g_pl_loss_and_gradient_match_jax(models):
    jg, jd, fg, fd = models
    _, _, x_in, z = _batch(1)
    pg = torch_state_dict_to_params(fg)
    c = jnp.zeros((N, 0))
    rng = jax.random.key(4)
    pl_mean = jnp.float32(0.5)

    def f(pg):
        loss, new_mean, lens, wa = JL.g_pl_loss(
            jg, pg, jnp.asarray(x_in), jnp.asarray(z), c, rng, pl_mean,
            style_mixing_prob=0.0)
        return loss, (new_mean, lens, wa)
    (want, (w_mean, w_lens, w_wa)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(pg)
    n = N // 2
    pl_noise = np.asarray(jax.random.normal(
        jax.random.split(rng, 5)[4], (n, 3, RES, RES))) / RES
    G, _ = _port(models)
    loss, new_mean, lens, wa = TL.g_pl_loss(
        G, _t(x_in), _t(z), torch.Generator().manual_seed(0),
        torch.tensor(0.5), style_mixing_prob=0.0, pl_noise=_t(pl_noise))
    loss.backward()
    _close_rel(loss, want, what="loss")
    _close_rel(new_mean, w_mean, what="pl_mean")
    _close_rel(lens, w_lens, what="pl_lengths")
    np.testing.assert_allclose(wa.numpy(), w_wa, rtol=1e-5, atol=1e-6)
    _check_grads(G, grads, "G")


def test_d_main_loss_and_gradient_match_jax(models):
    jg, jd, fg, fd = models
    real, mask, x_in, z = _batch(2)
    pg, pd = torch_state_dict_to_params(fg), torch_state_dict_to_params(fd)
    c = jnp.zeros((N, 0))

    def f(pd):
        return JL.d_main_loss(jg, jd, pg, pd, jnp.asarray(x_in),
                              jnp.asarray(mask), jnp.asarray(real),
                              jnp.asarray(z), c, jax.random.key(5),
                              style_mixing_prob=0.0)
    (want, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(pd)
    G, D = _port(models)
    G.requires_grad_(False)
    loss, taux = TL.d_main_loss(G, D, _t(x_in), _t(mask), _t(real), _t(z),
                                torch.Generator().manual_seed(0), 0.0)
    loss.backward()
    _close_rel(loss, want, what="loss")
    for k in ("scores_fake", "scores_real"):
        _close_rel(taux[k], aux[k], 1e-4, k)
    np.testing.assert_allclose(taux["w_avg"].numpy(), aux["w_avg"],
                               rtol=1e-5, atol=1e-6)
    _check_grads(D, grads, "D")


def test_d_r1_loss_and_gradient_match_jax(models):
    _, jd, _, fd = models
    real, mask, _, _ = _batch(3)
    pd = torch_state_dict_to_params(fd)
    c = jnp.zeros((N, 0))

    def f(pd):
        return JL.d_r1_loss(jd, pd, jnp.asarray(mask), jnp.asarray(real), c)
    (want, pen), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(pd)
    _, D = _port(models)
    loss, tpen = TL.d_r1_loss(D, _t(mask), _t(real))
    loss.backward()
    _close_rel(loss, want, what="loss")
    _close_rel(tpen, pen, what="r1 penalty")
    _check_grads(D, grads, "D")


# ---------------------------------------------------------------------------
# optimizer, EMA
# ---------------------------------------------------------------------------


def test_three_adam_steps_match_jax(models):
    """make_optimizer: lazy-reg scaling, the NaN scrub, frozen buffers;
    three steps on the same gradients."""
    _, _, fg, _ = models
    G, _ = _port(models)
    params = dict(torch_state_dict_to_params(fg))
    tx = JS.make_optimizer(lr=0.002, betas=(0.0, 0.99), reg_interval=4)
    state = tx.init(params)
    opt = TS.make_optimizer(TS.freeze_buffers(G), lr=0.002,
                            betas=(0.0, 0.99), reg_interval=4)
    rng = np.random.RandomState(7)
    for it in range(3):
        grads = {k: np.asarray(rng.randn(*np.shape(v)) * 10 ** -it, np.float32)
                 for k, v in fg.items()}
        first = next(k for k in grads if k.endswith("weight"))
        grads[first].flat[:3] = [np.nan, np.inf, -np.inf]
        jgrads = torch_state_dict_to_params(grads)
        upd, state = tx.update(jgrads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        for name, p in G.named_parameters():
            p.grad = _t(grads[name])
        TS.nan_scrub(TS.freeze_buffers(G))
        opt.step()
        opt.zero_grad(set_to_none=True)
    want = _flat(params)
    for name, v in G.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for name in want:
        if name.split(".")[-1] in BUFFERS:
            np.testing.assert_array_equal(want[name], fg[name])


def test_ema_update_and_beta_match_jax(models):
    _, _, fg, _ = models
    G, _ = _port(models)
    G2 = copy.deepcopy(G)
    with torch.no_grad():
        for t in list(G2.parameters()) + list(G2.buffers()):
            t.add_(1.0)
    want = _flat(JS.ema_update(torch_state_dict_to_params(fg),
                               torch_state_dict_to_params(
                                   {k: v + 1.0 for k, v in fg.items()}),
                               jnp.float32(0.25)))
    TS.ema_update(G, G2, 0.25)
    for name, v in G.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    for kimg, rampup, bs, nimg in [(10, None, 32, 0), (10, 0.05, 32, 0),
                                   (10, 0.05, 8, 10_000_000), (0.5, None, 4,
                                                               123)]:
        jc = JS.TrainConfig(ema_kimg=kimg, ema_rampup=rampup)
        tc = TS.TrainConfig(ema_kimg=kimg, ema_rampup=rampup)
        assert TS.compute_ema_beta(tc, bs, nimg) == \
            JS.compute_ema_beta(jc, bs, nimg)


def test_schedules_and_custom_optimizers_raise():
    """A schedule segment without its args and an optimizer the registry
    lacks (JAX's has no ``adamw`` either) raise when built."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(KeyError, match="args"):
        TS.make_optimizer(p, schedule=[{"type": "constant"}])
    with pytest.raises(KeyError, match="adamw"):
        TS.make_optimizer(p, optimizer={"type": "adamw"})


# ---------------------------------------------------------------------------
# one full step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_full_step_with_both_regs_matches_jax(models, accum):
    """One step of make_train_step with Gpl and R1 against the port's
    TrainStep on the same draws: params, G_ema, pl_mean, w_avg; with
    ``grad_accum`` 2, pl_mean and w_avg chain through the two rounds in
    JAX's order (every Gmain round, then every Gpl round).  Adam's
    first step moves an element by ±lr whatever its gradient's size, so an
    element whose gradient is within float error of 0 can go either way:
    such elements are counted apart and must be rare.  G's step also moves
    every noise_strength off 0, so the D phase's fakes carry each
    package's own noise stream, and D's gradients differ by that much."""
    jg, jd, fg, fd = models
    cfg = dict(style_mixing_prob=0.0, grad_accum=accum)
    jcfg, tcfg = JS.TrainConfig(**cfg), TS.TrainConfig(**cfg)
    state = {"params_g": torch_state_dict_to_params(fg),
             "params_d": torch_state_dict_to_params(fd)}
    g_tx = JS.make_optimizer(**jcfg.g_opt, reg_interval=4)
    d_tx = JS.make_optimizer(**jcfg.d_opt, reg_interval=16)
    state.update(params_gema=jax.tree.map(jnp.copy, state["params_g"]),
                 opt_g=g_tx.init(state["params_g"]),
                 opt_d=d_tx.init(state["params_d"]),
                 pl_mean=jnp.float32(0.0), step=jnp.int32(0))
    real, mask, _, _ = _batch(4)
    rng = jax.random.key(9)
    new, metrics = jax.jit(JS.make_train_step(jg, jd, jcfg),
                           static_argnames=("do_greg", "do_dreg"))(
        state, (jnp.asarray(real), jnp.asarray(mask)), rng,
        jnp.float32(0.9), do_greg=True, do_dreg=True)
    # JAX's draws: one key each, split once a round when accumulating
    _, k_gpl, _, k_z1, k_z2, k_z3 = jax.random.split(rng, 6)
    rounds = (lambda k: [k]) if accum == 1 else (
        lambda k: list(jax.random.split(k, accum)))
    nm = N // accum
    given = {k: _t(np.concatenate([jax.random.normal(kr, (nm, 32))
                                   for kr in rounds(kk)]))
             for k, kk in (("z1", k_z1), ("z2", k_z2), ("z3", k_z3))}
    given["pl_noise"] = _t(np.concatenate([jax.random.normal(
        jax.random.split(kr, 5)[4], (max(nm // 2, 1), 3, RES, RES)) / RES
        for kr in rounds(k_gpl)]))
    G, D = _port(models)
    step = TS.TrainStep(G, D, tcfg)
    tm = step(_t(real), _t(mask), torch.Generator().manual_seed(0), 0.9,
              do_greg=True, do_dreg=True, given=given)
    assert step.step == 1
    for k in ("loss_g", "pl_lengths", "r1_penalty", "scores_real",
              "scores_fake_g"):
        _close_rel(tm[k], metrics[k], 1e-4, k)
    # the D phase's fakes come from G after its Adam step (see above)
    for k in ("loss_d", "scores_fake_d"):
        _close_rel(tm[k], metrics[k], 1e-3, k)
    _close_rel(step.pl_mean, new["pl_mean"], 1e-4, "pl_mean")
    np.testing.assert_allclose(G.mapping.w_avg.numpy(),
                               new["params_g"]["mapping"]["w_avg"],
                               rtol=1e-5, atol=1e-6)
    lr_g, lr_d = 0.002 * 4 / 5, 0.002 * 16 / 17
    for mod, tree, lr in ((G, new["params_g"], lr_g),
                          (D, new["params_d"], lr_d),
                          (step.G_ema, new["params_gema"], lr_g * 0.1)):
        want = _flat(tree)
        flips = total = 0
        for name, v in mod.state_dict().items():
            if name.endswith("noise_strength"):
                continue
            diff = np.abs(v.numpy() - want[name])
            assert diff.max() <= 2 * lr + 1e-6, name
            flips += int((diff > 1e-5 + 1e-5 * np.abs(want[name])).sum())
            total += diff.size
        assert flips <= total // 100, (flips, total)
