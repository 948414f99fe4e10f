"""The port's LR schedules and optimizers against shgan_tpu's: every
segment type and a composed pipeline (``[i]`` equal, ``(count)`` within
one float32 ulp), and ``make_optimizer`` against JAX's optax chain over
five updates on the same parameters and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shgan_tpu.train import schedules as JSch
from shgan_tpu.train import step as JS
from shgan_torch.train import schedules as TSch
from shgan_torch.train import step as TS

PIPELINES = {
    "constant": [{"type": "constant", "args": {"lr": 1e-3, "step": 7}}],
    "poly": [{"type": "poly", "args": {"start_lr": 2e-3, "end_lr": 1e-5,
                                       "power": 0.9, "step": 11}}],
    "poly_int_power": [{"type": "poly", "args": {
        "start_lr": 3e-3, "end_lr": 0.0, "power": 2, "step": 9}}],
    "linear": [{"type": "linear", "args": {"start_lr": 0.0, "end_lr": 2e-3,
                                           "step": 4}}],
    "multistage": [{"type": "multistage", "args": {
        "start_lr": 1e-2, "milestones": [3, 7], "gamma": 0.1, "step": 10}}],
    "composed": [
        {"type": "linear", "args": {"start_lr": 1e-4, "end_lr": 1e-3,
                                    "step": 5}},
        {"type": "poly", "args": {"start_lr": 1e-3, "end_lr": 1e-6,
                                  "power": 0.9, "step": 6}},
        {"type": "multistage", "args": {"start_lr": 5e-4,
                                        "milestones": [2], "gamma": 0.5,
                                        "step": 4}},
        {"type": "constant", "args": {"lr": 1e-5, "step": 3}}],
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_schedule_matches_jax(name):
    """``[i]`` equals JAX's float64 closed forms exactly and raises past
    the end; ``(count)`` is within one float32 ulp of JAX's traced float32
    schedule for counts 0 … end + 5, clamped past the end."""
    js, ts = (JSch.get_scheduler(PIPELINES[name]),
              TSch.get_scheduler(PIPELINES[name]))
    assert ts.step == js.step
    assert [ts[i] for i in range(ts.step)] == [js[i] for i in range(js.step)]
    assert ts.to_list() == js.to_list()
    with pytest.raises(ValueError):
        ts[ts.step]
    for count in range(ts.step + 6):
        want = np.float32(js(jnp.int32(count)))
        got = ts(count)
        assert isinstance(got, np.float32)
        ulp = np.spacing(np.abs(want))
        assert abs(np.float64(got) - np.float64(want)) <= ulp, (count, got,
                                                                  want)


def test_empty_and_unknown_pipelines_raise():
    with pytest.raises(ValueError, match="empty"):
        TSch.get_scheduler([])
    with pytest.raises(KeyError):
        TSch.get_scheduler([{"type": "cosine", "args": {}}])


# (the port's make_optimizer kwargs, the same for JAX's)
OPTIMIZERS = {
    "default_adam": {},
    "adam_schedule": {"schedule": PIPELINES["composed"]},
    "registry_adam_wd": {"optimizer": {"type": "adam", "args": {
        "betas": [0.5, 0.9], "eps": 1e-6, "weight_decay": 0.01}}},
    "sgd_nesterov_wd": {"optimizer": {"type": "sgd", "args": {
        "momentum": 0.9, "nesterov": True, "weight_decay": 0.001}},
        "schedule": PIPELINES["linear"]},
}
SHAPES = {"conv.weight": (4, 3, 3, 3), "conv.bias": (4,),
          "conv.noise_strength": (), "fc.weight": (5, 6),
          "conv.noise_const": (8, 8), "mapping.w_avg": (6,)}
BUFFERS = ("noise_const", "w_avg")


def _nest(flat):
    out = {}
    for k, v in flat.items():
        a, b = k.split(".")
        out.setdefault(a, {})[b] = v
    return out


@pytest.mark.parametrize("reg_interval", [None, 4])
@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_make_optimizer_matches_optax(case, reg_interval):
    """Five updates of the same parameters on the same gradients (a NaN
    and ±inf among them, scrubbed first); the LR of update ``k`` set just
    before it.  Each parameter within 1e-6 relative (atol 1e-9) of JAX's;
    the buffers, which the optimizer never sees in the port and which
    JAX's ``freeze_buffers`` holds, unchanged in both."""
    kw = OPTIMIZERS[case]
    rng = np.random.RandomState(0)
    init = {k: np.asarray(rng.randn(*s), np.float32)
            for k, s in SHAPES.items()}
    params = jax.tree.map(jnp.asarray, _nest(init))
    tx = JS.make_optimizer(lr=0.003, betas=(0.0, 0.99),
                           reg_interval=reg_interval, **kw)
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()
               if k.split(".")[-1] not in BUFFERS}
    opt = TS.make_optimizer(list(tparams.values()), lr=0.003,
                            betas=(0.0, 0.99), reg_interval=reg_interval,
                            **kw)
    for k in range(5):
        grads = {n: np.asarray(rng.randn(*s) * 10 ** -k, np.float32)
                 for n, s in SHAPES.items()}
        grads["fc.weight"].flat[:3] = [np.nan, np.inf, -np.inf]
        upd, state = tx.update(jax.tree.map(jnp.asarray, _nest(grads)),
                               state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        for n, p in tparams.items():
            p.grad = torch.from_numpy(grads[n])
        TS.nan_scrub(list(tparams.values()))
        TS.optimizer_step(opt, k)
        opt.zero_grad(set_to_none=True)
    for n in SHAPES:
        a, b = n.split(".")
        want = np.asarray(params[a][b])
        if b in BUFFERS:
            np.testing.assert_array_equal(want, init[n])
            continue
        np.testing.assert_allclose(tparams[n].detach().numpy(), want,
                                   rtol=1e-6, atol=1e-9, err_msg=n)


def test_lr_of_each_update():
    """``lr_at(k)``: ``schedule(k) * r`` in float32 with a schedule (``lr``
    ignored), ``lr * r`` without; the default Adam's betas ``** r``, a
    registry Adam's its own (the optimizer's default (0.9, 0.999) with no
    args)."""
    p = [torch.nn.Parameter(torch.zeros(3))]
    sched = PIPELINES["composed"]
    opt = TS.make_optimizer(p, lr=5.0, reg_interval=4, schedule=sched)
    js = JSch.get_scheduler(sched)
    for k in range(20):
        assert opt.lr_at(k) == float(np.float32(js(jnp.int32(k)))
                                     * np.float32(0.8))
    opt = TS.make_optimizer(p, lr=0.002, betas=(0.0, 0.99), reg_interval=16)
    assert opt.lr_at(7) == 0.002 * 16 / 17
    assert opt.param_groups[0]["betas"] == (0.0, 0.99 ** (16 / 17))
    opt = TS.make_optimizer(p, betas=(0.0, 0.99), reg_interval=16,
                            optimizer={"type": "adam"})
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)
    assert opt.lr_at(0) == 0.002 * 16 / 17
    TS.optimizer_step(opt, 3)
    assert opt.param_groups[0]["lr"] == 0.002 * 16 / 17


def test_sgd_without_momentum_keeps_no_trace():
    """optax's ``sgd(momentum=0)`` has no trace, Nesterov or not."""
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = TSch.get_optimizer({"type": "sgd", "args": {"nesterov": True}}, p,
                             0.1)
    for _ in range(2):
        p[0].grad = torch.ones(3)
        opt.step()
    torch.testing.assert_close(p[0].detach(), torch.full((3,), 0.8),
                               rtol=0, atol=1e-7)
    assert not opt.state[p[0]].get("momentum_buffer")


def test_resumed_optimizer_continues_the_schedule(tmp_path):
    """A train state saved after update 2 and loaded into a fresh step
    runs update 3 at the schedule's LR of count 3: the count comes back
    with the state."""
    from shgan_torch.checkpoint.train_state import (load_train_state,
                                                    save_train_state)
    from shgan_torch.models import get_model
    from test_torch_models import tiny_cfg
    from test_torch_train_ops import tiny_d_cfg
    sched = PIPELINES["linear"]
    tc = TS.TrainConfig(g_opt={"schedule": sched},
                        d_opt={"optimizer": {"type": "sgd",
                                             "args": {"momentum": 0.5}}})
    step = TS.TrainStep(get_model(tiny_cfg(16)), get_model(tiny_d_cfg(16)),
                        tc)
    step.step = 3
    save_train_state(str(tmp_path / "snap"), step)
    fresh = TS.TrainStep(get_model(tiny_cfg(16), seed=4),
                         get_model(tiny_d_cfg(16), seed=4), tc)
    load_train_state(str(tmp_path / "snap"), fresh)
    assert fresh.step == 3
    want = float(np.float32(JSch.get_scheduler(sched)(jnp.int32(3)))
                 * np.float32(0.8))
    assert fresh.opt_g.lr_at(fresh.step) == want
    assert isinstance(fresh.opt_d, torch.optim.SGD)
