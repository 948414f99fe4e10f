"""The StyleGAN2 family and the remaining model variants of the port against
shgan_tpu on the CPU, at tiny widths: ``StyleGANSynthesis`` and
``StyleGANGenerator`` (with truncation), ``CoModSynthesisPlur``, the mapping
with ``c_dim > 0``, the class-conditional discriminator (and an epilogue
that projects onto ``cmap``), the encoder with minibatch stddev, and
``unconditional_g_main_loss`` with its gradient.

Weights are carried from the JAX parameter trees by ``params_from_jax``;
every bias and ``noise_strength`` is moved off its zero init so those paths
count.  Per-pixel parity runs with ``noise_mode="const"`` or ``"none"``;
the loss, whose synthesis noise is random, runs with both packages' noise
replaced by the same numpy normals per resolution (the noise streams differ
by design), and the pluralistic w0 draw is JAX's, handed to the port.
Tolerance: float32, ``rtol = atol = 1e-4`` on every output and gradient
leaf (the two CPU backends sum the convolutions in other orders).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import shgan_tpu.ops.noise as jax_noise
import shgan_torch.ops.noise_bias_act as nba
from shgan_tpu.checkpoint import (params_to_flat_state_dict,
                                  torch_state_dict_to_params)
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.models.discriminator import DiscrimEpilogue as JaxEpilogue
from shgan_tpu.train import loss as JL
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.models import get_model
from shgan_torch.models.discriminator import DiscrimEpilogue
from shgan_torch.models.synthesis import StyleGANSynthesis, plural_noise
from shgan_torch.runtime.config import model_cfg_bank
from shgan_torch.train import loss as TL
from test_torch_models import tiny_cfg

RES = 32
ACT = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
TOL = dict(rtol=1e-4, atol=1e-4)
NUM_WS = 2 * (int(np.log2(RES)) - 1)


def sg_synthesis_cfg():
    return {"type": "stylegan2_synthesis",
            "args": dict(w_dim=32, resolution=RES, rgb_n=3, ch_base=256,
                         ch_max=8, use_fp16_after_res=None,
                         resample_filter=[1, 3, 3, 1], activation=ACT)}


def mapping_cfg(c_dim=0):
    return {"type": "stylegan2_mapping",
            "args": dict(z_dim=32, c_dim=c_dim, w_dim=32, num_ws=NUM_WS,
                         num_layers=2, activation=ACT, lr_multiplier=0.01)}


def sg_generator_cfg(c_dim=0):
    return {"type": "stylegan2_generator",
            "args": {"mapping": mapping_cfg(c_dim),
                     "synthesis": sg_synthesis_cfg()}}


def d_cfg(c_dim=None, cmap_dim=None):
    return {"type": "stylegan2_discriminator",
            "args": dict(resolution=RES, ic_n=3, ch_base=256, ch_max=8,
                         use_fp16_before_res=None, activation=ACT,
                         mbstd_group_size=2, mbstd_c_n=1, c_dim=c_dim,
                         cmap_dim=cmap_dim)}


def _moved(flat, seed):
    """Biases and noise strengths off their zero init; a nonzero w_avg."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k.endswith("noise_strength"):
            v = np.float32(0.3)
        elif k.endswith(".bias") or k.endswith("w_avg"):
            v = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
        out[k] = v
    return out


def _pair(cfg, seed=0):
    """(JAX model, JAX params, port model) with the same weights."""
    jm = jax_get_model(cfg)
    flat = _moved(params_to_flat_state_dict(jm.init(jax.random.key(seed))),
                  seed + 1)
    tm = get_model(cfg)
    tm.load_state_dict(params_from_jax(flat), strict=True)
    return jm, torch_state_dict_to_params(flat), tm


@pytest.fixture(scope="module")
def generator():
    return _pair(sg_generator_cfg(), 0)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_stylegan_parameter_names_match_jax(generator):
    jm, jp, tm = generator
    flat = params_to_flat_state_dict(jp)
    sd = tm.state_dict()
    assert set(sd) == set(flat)
    assert "synthesis.b4.const" in sd and "synthesis.b8.conv0.weight" in sd
    for k, v in sd.items():
        assert tuple(v.shape) == np.shape(flat[k]), k


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_stylegan_synthesis_matches_jax(generator, noise_mode):
    jm, jp, tm = generator
    ws = np.random.RandomState(1).randn(2, NUM_WS, 32).astype(np.float32)
    want = jax.jit(lambda p, w: jm.synthesis(p, w, noise_mode=noise_mode))(
        jp["synthesis"], jnp.asarray(ws))
    with torch.no_grad():
        got = tm.synthesis(torch.from_numpy(ws), noise_mode=noise_mode)
    assert got.shape == (2, 3, RES, RES)
    _close(got, want)


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 4)])
def test_stylegan_generator_matches_jax(generator, psi, cutoff):
    jm, jp, tm = generator
    z = np.random.RandomState(2).randn(3, 32).astype(np.float32)
    want = jax.jit(lambda p, z: jm(p, z, truncation_psi=psi,
                                   truncation_cutoff=cutoff,
                                   noise_mode="const"))(jp, jnp.asarray(z))
    with torch.no_grad():
        got = tm(torch.from_numpy(z), truncation_psi=psi,
                 truncation_cutoff=cutoff, noise_mode="const")
    _close(got, want)


def test_stylegan2_generator_256_builds_as_configured():
    """The bank's configuration at full width: 14 ws, blocks above 16² in
    bfloat16, the same config dict as the JAX bank's."""
    from shgan_tpu.runtime.config import model_cfg_bank as jax_bank
    cfg = model_cfg_bank()("stylegan2_generator_256")
    assert cfg == jax_bank()("stylegan2_generator_256")
    G = get_model(cfg)
    syn = G.synthesis
    assert G.num_ws == syn.num_ws == 14
    assert [getattr(syn, f"b{r}").dtype for r in syn.block_res] == (
        [torch.float32] * 3 + [torch.bfloat16] * 4)
    assert syn.b256.conv1.weight.shape == (64, 64, 3, 3)


def _plur_cfg():
    cfg = tiny_cfg(RES)
    cfg["args"]["synthesis"]["type"] = "comodgan_synthesis_plur"
    return cfg


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_comod_synthesis_plur_matches_jax(noise_mode):
    """The pluralistic variant: JAX's keyed-constant w0 draw (rng None)
    given to the port as ``w0_noise``; the draw moves the output."""
    jm, jp, tm = _pair(_plur_cfg(), 3)
    rng = np.random.RandomState(4)
    n = 2
    real = rng.randn(n, 3, RES, RES).astype(np.float32)
    mask = (rng.rand(n, 1, RES, RES) > 0.4).astype(np.float32)
    x = np.concatenate([mask - 0.5, real * mask], axis=1)
    ws = rng.randn(n, NUM_WS, 32).astype(np.float32)
    jx, jfeats = jax.jit(jm.encoder)(jp["encoder"], jnp.asarray(x))
    want = jax.jit(lambda p, x, f, w: jm.synthesis(
        p, x, f, w, noise_mode=noise_mode))(jp["synthesis"], jx, jfeats,
                                            jnp.asarray(ws))
    draw = np.array(jax.random.normal(jax.random.key(0), jx.shape,
                                      jx.dtype))
    with torch.no_grad():
        tx, tfeats = tm.encoder(torch.from_numpy(x))
        got = tm.synthesis(tx, tfeats, torch.from_numpy(ws),
                           noise_mode=noise_mode,
                           w0_noise=torch.from_numpy(draw))
        clean = tm.synthesis(tx, tfeats, torch.from_numpy(ws),
                             noise_mode=noise_mode,
                             w0_noise=torch.zeros(draw.shape))
    _close(got, want)
    assert (got - clean).abs().max() > 1e-3


def test_plural_noise_is_keyed():
    w0 = torch.zeros(2, 8)
    a = plural_noise(w0, "const", None)
    np.testing.assert_array_equal(a, plural_noise(w0, "none", 123))
    r1, r2 = (plural_noise(w0, "random", s) for s in (1, 2))
    np.testing.assert_array_equal(r1, plural_noise(w0, "random", 1))
    assert not torch.equal(r1, r2) and not torch.equal(r1, a)
    with pytest.raises(ValueError, match="noise_seed"):
        plural_noise(w0, "random", None)


@pytest.mark.parametrize("z_dim,num_ws", [(32, NUM_WS), (0, None)])
def test_mapping_with_labels_matches_jax(z_dim, num_ws):
    cfg = {"type": "stylegan2_mapping",
           "args": dict(z_dim=z_dim, c_dim=5, w_dim=32, num_ws=num_ws,
                        num_layers=3, embed_features=16, activation=ACT,
                        lr_multiplier=0.01,
                        w_avg_beta=0.995 if num_ws else None)}
    jm, jp, tm = _pair(cfg, 5)
    assert "embed.weight" in tm.state_dict()
    rng = np.random.RandomState(6)
    z = rng.randn(3, max(z_dim, 1)).astype(np.float32)[:, :z_dim]
    c = np.eye(5, dtype=np.float32)[[0, 3, 4]]
    want = jm(jp, jnp.asarray(z) if z_dim else None, jnp.asarray(c))
    with torch.no_grad():
        got = tm(torch.from_numpy(z) if z_dim else None, torch.from_numpy(c))
    _close(got, want)
    with pytest.raises(ValueError, match="needs c"):
        tm(torch.from_numpy(z) if z_dim else None)


def test_conditional_discriminator_matches_jax():
    jm, jp, tm = _pair(d_cfg(c_dim=4, cmap_dim=16), 7)
    assert "mapping.embed.weight" in tm.state_dict()
    rng = np.random.RandomState(8)
    img = rng.randn(4, 3, RES, RES).astype(np.float32)
    c = np.eye(4, dtype=np.float32)
    want = jax.jit(jm)(jp, jnp.asarray(img), jnp.asarray(c))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(c))
    assert got.shape == (4, 1)
    _close(got, want)


def test_discriminator_epilogue_projects_onto_cmap():
    je = JaxEpilogue(8, resolution=4, cmap_dim=16, mbstd_group_size=2,
                     mbstd_c_n=1, activation=ACT)
    flat = _moved(params_to_flat_state_dict(je.init(jax.random.key(9))), 10)
    te = DiscrimEpilogue(8, resolution=4, cmap_dim=16, mbstd_group_size=2,
                         mbstd_c_n=1, activation=ACT)
    te.load_state_dict(params_from_jax(flat), strict=True)
    rng = np.random.RandomState(11)
    x = rng.randn(4, 8, 4, 4).astype(np.float32)
    cmap = rng.randn(4, 16).astype(np.float32)
    want = je(torch_state_dict_to_params(flat), jnp.asarray(x),
              cmap=jnp.asarray(cmap))
    with torch.no_grad():
        got = te(torch.from_numpy(x), torch.from_numpy(cmap))
    assert got.shape == (4, 1)
    _close(got, want)


@pytest.mark.parametrize("c_dim", [None, 3])
def test_encoder_with_mbstd_matches_jax(c_dim):
    cfg = {"type": "comodgan_encoder",
           "args": dict(resolution=RES, ic_n=4, oc_n=32, ch_base=256,
                        ch_max=8, use_fp16_before_res=None, activation=ACT,
                        mbstd_group_size=2, mbstd_c_n=1, c_dim=c_dim,
                        cmap_dim=8 if c_dim else None, use_dropout=False,
                        has_extra_final_layer=True)}
    jm, jp, tm = _pair(cfg, 12)
    assert tm.b4.conv.weight.shape[1] == 9   # 8 channels + 1 stddev
    rng = np.random.RandomState(13)
    x = rng.randn(4, 4, RES, RES).astype(np.float32)
    c = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]] if c_dim else None
    want, wfeats = jax.jit(jm)(jp, jnp.asarray(x),
                               None if c is None else jnp.asarray(c))
    with torch.no_grad():
        got, gfeats = tm(torch.from_numpy(x),
                         None if c is None else torch.from_numpy(c))
    _close(got, want)
    for r in gfeats:
        _close(gfeats[r], wfeats[r])


def _noise_plane(res, n):
    return np.random.RandomState(res).randn(n, 1, res, res).astype(
        np.float32)


def test_unconditional_g_main_loss_matches_jax(monkeypatch):
    """The loss, its new w_avg and every G gradient leaf, on the same
    draws: z, JAX's mixing cutoff and second z handed to the port, and the
    same normals per resolution as both packages' synthesis noise."""
    jg, jpg, tg = _pair(sg_generator_cfg(), 14)
    jd, jpd, td = _pair(d_cfg(), 15)
    n = 2
    monkeypatch.setattr(jax_noise, "random_noise",
                        lambda rng, batch, res, dtype=jnp.float32:
                        jnp.asarray(_noise_plane(res, batch), dtype))
    monkeypatch.setattr(nba, "philox_normal_plain",
                        lambda key, batch, res, device="cpu", row0=0:
                        torch.from_numpy(_noise_plane(res, batch)[:, 0]))
    z = np.random.RandomState(16).randn(n, 32).astype(np.float32)
    key = jax.random.key(17)
    # JAX's own mixing draws (shgan_tpu/train/loss.py:156-163)
    _, k_mix, _ = jax.random.split(key, 3)
    k_cut, k_p, k_z = jax.random.split(k_mix, 3)
    cutoff = int(jax.random.randint(k_cut, (), 1, NUM_WS))
    assert float(jax.random.uniform(k_p, ())) < 0.9   # this key mixes
    z2 = np.array(jax.random.normal(k_z, z.shape, z.dtype))

    def f(pg):
        return JL.unconditional_g_main_loss(jg, jd, pg, jpd, jnp.asarray(z),
                                            None, key, 0.9)
    (want, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jpg)
    td.requires_grad_(False)
    loss, taux = TL.unconditional_g_main_loss(
        tg, td, torch.from_numpy(z), None, torch.Generator().manual_seed(0),
        0.9, mix=(cutoff, torch.from_numpy(z2)))
    loss.backward()
    _close(loss, want)
    _close(taux["w_avg"], aux["w_avg"])
    flat = params_to_flat_state_dict(grads)
    seen = 0
    for name, p in tg.named_parameters():
        w = np.asarray(flat[name])
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name, **TOL)
        seen += 1
    assert seen > 20


def test_unconditional_g_main_loss_draws_from_the_generator():
    """With no ``mix`` the draws come from the generator: the same seed
    gives the same loss, and w_avg moves."""
    G, D = get_model(sg_generator_cfg(), seed=1), get_model(d_cfg(), seed=2)
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(3))
    runs = [TL.unconditional_g_main_loss(G, D, z, None,
                                         torch.Generator().manual_seed(s))
            for s in (4, 4, 5)]
    assert float(runs[0][0].detach()) == float(runs[1][0].detach())
    assert torch.isfinite(runs[2][0])
    assert not torch.equal(runs[0][1]["w_avg"], G.mapping.w_avg)


def test_synthesis_is_a_registry_type():
    syn = get_model(sg_synthesis_cfg())
    assert isinstance(syn, StyleGANSynthesis) and syn.num_ws == NUM_WS
