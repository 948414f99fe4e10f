"""Per-block rematerialization (``remat``, ``shgan_torch/models/remat.py``)
on the CPU at tiny widths: a remat train step against the same step
without it (bit for bit), against JAX's step over models built with
``remat=True``, the bytes it keeps for the backward, the launch rule of
``chip_smoke.py`` with its recompute terms, the train stage's
``train.remat``, and two gloo ranks on the data axis and on the model axis.
"""

import copy
import importlib
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import torch_state_dict_to_params
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.train import loss as JL
from shgan_tpu.train import step as JS
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.main import build_config, run
from shgan_torch.models import get_model
from shgan_torch.runtime.stages import remat_configs
from shgan_torch.train import TrainConfig, TrainStep
from shgan_torch.train import loss as TL
from shgan_torch.train import step as TS
from test_torch_models import tiny_cfg
from test_torch_parallel import _npz
from test_torch_spatial import _finish, _start
from test_torch_train import (N, RES, _check_grads, _close_rel, _flat, _t,
                              _with_biases)
from test_torch_train_ops import tiny_d_cfg
from test_torch_train_stage import _count_launches

HERE = osp.dirname(osp.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny steps here are launch-bound: one intra-op thread runs them
    about as fast as eight, and keeps them fast while other test workers
    load every core (as ``test_torch_nested_eval.py`` does)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _smoke():
    """``chip_smoke.py``, whose launch rule the tests hold the port to."""
    sys.path.insert(0, osp.dirname(HERE))
    return importlib.import_module("chip_smoke")


def _tiny(remat, bf16=False, res=RES):
    """The tiny G (``tiny_cfg``) and D, every noise strength 0.3 so the
    random noise reaches the image; with ``bf16`` the blocks above 8² in
    bfloat16."""
    cg, cd = tiny_cfg(res), tiny_d_cfg(res)
    if bf16:
        cg["args"]["encoder"]["args"]["use_fp16_before_res"] = 8
        cg["args"]["synthesis"]["args"]["use_fp16_after_res"] = 8
        cd["args"]["use_fp16_before_res"] = 8
    if remat:
        cg, cd = remat_configs(cg, cd)
    G, D = get_model(cg, seed=0), get_model(cd, seed=1)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    return G, D


def _inputs(res=RES, n=4):
    g = torch.Generator().manual_seed(0)
    real = torch.rand(n, 3, res, res, generator=g) * 2 - 1
    mask = (torch.rand(n, 1, res, res, generator=g) > 0.5).float()
    return real, mask


def _recorded_step(remat, bf16):
    """A step with Gpl and R1, then a main-only one (random noise, style
    mixing and dropout on): the gradients as the NaN scrub reads them, the
    metrics, ``pl_mean``, ``w_avg`` and the weights."""
    G, D = _tiny(remat, bf16)
    step = TrainStep(G, D, TrainConfig())
    grads, scrub = [], TS.nan_scrub

    def recording(params):
        grads.append([p.grad.clone() for p in params])
        return scrub(params)
    real, mask = _inputs()
    TS.nan_scrub = recording
    try:
        out = [step(real, mask, torch.Generator().manual_seed(1), 0.9, True,
                    True),
               step(real, mask, torch.Generator().manual_seed(2), 0.9,
                    False, False)]
    finally:
        TS.nan_scrub = scrub
    return grads, out, step


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_remat_step_equals_the_step_without_it(bf16):
    """Gradients, losses, ``pl_mean``, ``w_avg`` and weights bit for bit:
    the recompute draws the same noise (Philox counters from the integer
    seed) and rounds a bf16 block as the first forward did.  The global
    RNG stays still over the remat step: no checkpointed block draws from
    it, so its state need not be stashed."""
    ga, ma, sa = _recorded_step(False, bf16)
    rng = torch.get_rng_state()
    gb, mb, sb = _recorded_step(True, bf16)
    assert torch.equal(rng, torch.get_rng_state())
    assert sb.G.synthesis.remat and not sa.G.synthesis.remat
    assert len(ga) == len(gb) == 4
    for xs, ys in zip(ga, gb):
        assert len(xs) == len(ys) > 20
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)
    for a, b in zip(ma, mb):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(sa.pl_mean, sb.pl_mean) and float(sa.pl_mean) > 0
    assert torch.equal(sa.G.mapping.w_avg, sb.G.mapping.w_avg)
    for k, v in sa.G.state_dict().items():
        assert torch.equal(v, sb.G.state_dict()[k]), k


def test_remat_keeps_fewer_bytes_for_the_backward():
    """The bytes saved for the backward over one Gmain forward (G and D),
    each storage counted once: a checkpointed block keeps its inputs, not
    its activations."""
    def saved_bytes(remat):
        G, D = _tiny(remat, res=64)
        D.requires_grad_(False)
        real, mask = _inputs(64)
        x_in = torch.cat([mask - 0.5, real * mask], dim=1)
        seen = {}

        def pack(t):
            seen[(t.untyped_storage().data_ptr(), t.dtype)] = \
                t.untyped_storage().nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = TL.g_main_loss(G, D, x_in, mask,
                                     torch.randn(4, 32), torch.Generator()
                                     .manual_seed(1))
        loss.backward()
        return sum(seen.values())
    plain, remat = saved_bytes(False), saved_bytes(True)
    assert remat < 0.6 * plain, (remat, plain)


@pytest.mark.parametrize("res", [32, 64])
def test_chip_smoke_launch_rule_counts_a_remat_step(res, monkeypatch):
    """The launch counts chip_smoke.py holds a remat step to (the
    recompute terms of ``expected_train_launches``, from the modules'
    checkpointed blocks) against the calls a remat step makes, counted
    where each kernel's wrapper would launch it; no recompute term without
    remat."""
    smoke = _smoke()
    counts = _count_launches(monkeypatch)
    G, D = _tiny(True, res=res)
    step = TrainStep(G, D, TrainConfig())
    sites, redo = smoke.train_sites(G, D), smoke.train_sites(G, D,
                                                             remat=True)
    # every K2 call sits in a checkpointed block, every synthesis layer
    # but b4's conv, every conv epilogue but the encoder's and D's 4² conv
    assert redo[:3] == sites[:3] and redo[3] == sites[3] - 1
    assert redo[5:7] == (sites[5] - 1, sites[6] - 1)
    assert smoke.train_sites(*_tiny(False, res=res), remat=True) == (0,) * 8
    real, mask = _inputs(res)
    for greg, dreg in [(True, True), (False, False), (True, False),
                       (False, True)]:
        counts.clear()
        step(real, mask, torch.Generator().manual_seed(1), 0.9, greg, dreg)
        want = smoke.expected_train_launches(*sites, greg, dreg,
                                             recompute=redo)
        assert counts == {k: v for k, v in want.items() if v}, (greg, dreg)
        plain = smoke.expected_train_launches(*sites, greg, dreg)
        assert want["upfirdn2d"] > plain["upfirdn2d"]
        assert want["noise_bias_act_grad"] == plain["noise_bias_act_grad"]


def test_train_stage_remat_checkpoints_the_models(tmp_path, monkeypatch):
    """``train.remat: true`` on ``smoke_train``: G's encoder and synthesis
    and D are built with remat (G_ema too, a copy of G), one log line says
    so, the caller's config is left as it was, and each step's launches
    follow the remat rule."""
    smoke = _smoke()
    counts = _count_launches(monkeypatch)
    cfg = build_config("smoke_train", log_root=str(tmp_path),
                       overrides={"train.experiment_id": 0,
                                  "train.total_kimg": 0.024,
                                  "train.image_snapshot_ticks": 0,
                                  "train.remat": True})
    before = copy.deepcopy(cfg)
    per_step = []
    rv = run(cfg, device="cpu",
             on_step_start=lambda i: counts.clear(),
             on_step=lambda i, m: per_step.append(dict(counts)))
    assert cfg == before
    assert "remat" not in cfg["model_g"]["args"]["encoder"].get("args", {})
    step = rv["step"]
    for m in (step.G.encoder, step.G.synthesis, step.D,
              step.G_ema.encoder, step.G_ema.synthesis):
        assert m.remat is True
    log = open(osp.join(cfg["train"]["log_dir"], "train.log")).read()
    assert log.count("remat: ") == 1
    sites = smoke.train_sites(step.G, step.D)
    redo = smoke.train_sites(step.G, step.D, remat=True)
    tc = step.cfg
    assert len(per_step) == 3
    for i, got in enumerate(per_step):
        want = smoke.expected_train_launches(
            *sites, i % tc.g_reg_interval == 0, i % tc.d_reg_interval == 0,
            recompute=redo)
        assert got == {k: v for k, v in want.items() if v}, i


# JAX's compile of a remat step grows with the depth: 16² keeps two
# checkpointed blocks in each network
JAX_RES = 16


def _jax_remat_models():
    """JAX's tiny G (dropout off) and D built with ``remat=True`` and the
    port's from the same configs, on the port's initial weights with
    random biases (each noise strength 0, so the noise streams, which
    differ by design, drop out of G's phase)."""
    cg = copy.deepcopy(tiny_cfg(JAX_RES))
    cg["args"]["encoder"]["args"]["use_dropout"] = False
    cg, cd = remat_configs(cg, tiny_d_cfg(JAX_RES))
    G, D = get_model(cg, seed=0), get_model(cd, seed=1)

    def flat(m, seed):
        return _with_biases({k: v.numpy() for k, v in m.state_dict().items()
                             if not k.endswith("resample_filter")}, seed)
    fg, fd = flat(G, 1), flat(D, 2)
    G.load_state_dict(params_from_jax(fg), strict=True)
    D.load_state_dict(params_from_jax(fd), strict=True)
    jg, jd = jax_get_model(cg), jax_get_model(cd)
    assert jg.encoder.remat and jg.synthesis.remat and jd.remat
    assert G.encoder.remat and G.synthesis.remat and D.remat
    return jg, jd, fg, fd, G, D


def test_remat_step_matches_jax_remat_step():
    """The port's remat step against JAX's ``make_train_step`` over models
    built with ``remat=True``, on the same draws, by the rules of
    ``test_torch_train.py::test_full_step_with_both_regs_matches_jax``:
    losses within 1e-4 (the D phase's, whose fakes carry each package's
    noise after G's update, 1e-3), weights within 2 LR with at most 1 %
    of elements apart; and D's R1 gradient through the checkpointed blocks'
    double backward each leaf within 1e-3 max|g| + 1e-6 of JAX's.  (G's
    remat gradient equals the port's plain one bit for bit, which
    ``test_torch_train.py`` holds to JAX's leaf by leaf.)"""
    jg, jd, fg, fd, G, D = _jax_remat_models()
    D_r1 = copy.deepcopy(D)
    cfg = dict(style_mixing_prob=0.0)
    jcfg, tcfg = JS.TrainConfig(**cfg), TS.TrainConfig(**cfg)
    pg, pd = torch_state_dict_to_params(fg), torch_state_dict_to_params(fd)
    g_tx = JS.make_optimizer(**jcfg.g_opt, reg_interval=4)
    d_tx = JS.make_optimizer(**jcfg.d_opt, reg_interval=16)
    state = {"params_g": pg, "params_d": pd,
             "params_gema": jax.tree.map(jnp.copy, pg),
             "opt_g": g_tx.init(pg), "opt_d": d_tx.init(pd),
             "pl_mean": jnp.float32(0.0), "step": jnp.int32(0)}
    rng = np.random.RandomState(4)
    real = rng.randn(N, 3, JAX_RES, JAX_RES).astype(np.float32)
    mask = (rng.rand(N, 1, JAX_RES, JAX_RES) > 0.4).astype(np.float32)
    key = jax.random.key(9)
    new, metrics = jax.jit(JS.make_train_step(jg, jd, jcfg),
                           static_argnames=("do_greg", "do_dreg"))(
        state, (jnp.asarray(real), jnp.asarray(mask)), key,
        jnp.float32(0.9), do_greg=True, do_dreg=True)
    _, k_gpl, _, k_z1, k_z2, k_z3 = jax.random.split(key, 6)
    given = {k: _t(jax.random.normal(kk, (N, 32)))
             for k, kk in (("z1", k_z1), ("z2", k_z2), ("z3", k_z3))}
    given["pl_noise"] = _t(jax.random.normal(
        jax.random.split(k_gpl, 5)[4], (N // 2, 3, JAX_RES, JAX_RES))
        / JAX_RES)
    step = TS.TrainStep(G, D, tcfg)
    tm = step(_t(real), _t(mask), torch.Generator().manual_seed(0), 0.9,
              do_greg=True, do_dreg=True, given=given)
    for k in ("loss_g", "pl_lengths", "r1_penalty", "scores_real",
              "scores_fake_g"):
        _close_rel(tm[k], metrics[k], 1e-4, k)
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

    c = jnp.zeros((N, 0))

    def r1(p):
        return JL.d_r1_loss(jd, p, jnp.asarray(mask), jnp.asarray(real),
                            c)[0]
    r1_want, r1_grads = jax.jit(jax.value_and_grad(r1))(pd)
    loss, _ = TL.d_r1_loss(D_r1, _t(mask), _t(real))
    loss.backward()
    _close_rel(loss, r1_want, what="r1 loss")
    _check_grads(D_r1, r1_grads, "D")


def test_remat_on_two_ranks(tmp_path):
    """Two gloo ranks of ``tests/torch_mh_driver.py``.  Data axis
    (``remat_step``): the remat step equals the same ranks' step without
    remat bit for bit (every rank recomputes its blocks in the same order,
    so the recompute's style gathers pair up), the ranks' replicas are
    equal, and it equals one process's step by ``test_torch_parallel``'s
    rule (each network within 1e-5 of its norm, ``w_avg`` and ``pl_mean``
    within 1e-6).  Model axis (``spatial_remat``, ``spatial_sharding`` at
    16 over 2 ranks): the remat step equals the sharded step without remat
    bit for bit, the halo exchanges and sums replayed in the backward; and
    a G forward under the sharding whose backward runs outside it (as the
    card's autograd thread does) recomputes on the slabs."""
    data, model = str(tmp_path / "data"), str(tmp_path / "model")
    groups = [_start(data, 2, 1, "remat_step"),
              _start(model, 2, 2, "spatial_remat")]
    for procs in groups:
        _finish(procs)
    r0, r1 = (_npz(osp.join(data, f"remat_step_rank{r}.npz"))
              for r in (0, 1))
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    keys = [k[6:] for k in r0 if k.startswith("remat_")]
    assert len(keys) > 50
    for k in keys:
        np.testing.assert_array_equal(r0["remat_" + k], r0["plain_" + k],
                                      err_msg=k)
    for net in ("G", "D"):
        ks = [k for k in keys if k.startswith(net + "0_")]
        assert ks
        diff = np.sqrt(sum(np.sum((r0["remat_" + k] - r0["one_" + k]) ** 2)
                           for k in ks))
        norm = np.sqrt(sum(np.sum(r0["one_" + k] ** 2) for k in ks))
        assert diff <= 1e-5 * norm, (net, diff / norm)
    for k in ("w_avg", "pl_mean"):
        np.testing.assert_allclose(r0["remat_" + k], r0["one_" + k],
                                   rtol=1e-6, atol=1e-9)
    assert float(r0["one_pl_mean"]) > 0
    m0, m1 = (_npz(osp.join(model, f"spatial_remat_rank{r}.npz"))
              for r in (0, 1))
    for m in (m0, m1):
        keys = [k[6:] for k in m if k.startswith("remat_")]
        assert len(keys) > 50
        for k in keys:
            np.testing.assert_array_equal(m["remat_" + k], m["plain_" + k],
                                          err_msg=k)
        assert m["halo_bytes_remat"] > m["halo_bytes_plain"] > 0
    for k in m0:
        if "bytes" not in k:
            np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)
