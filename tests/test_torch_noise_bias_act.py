"""The fused synthesis epilogue (``shgan_torch/ops/noise_bias_act.py``) on the
CPU: its plain version against the chain the layers ran before it, bit for
bit; a tiny ``SynthesisLayer`` and the tiny generator against shgan_tpu
(``noise_mode`` const or none: the noise streams differ by design); the
dispatcher's routing and argument checks."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import (params_to_flat_state_dict,
                                  torch_state_dict_to_params)
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.models.layers import SynthesisLayer as JaxSynthesisLayer
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.models import get_model
from shgan_torch.models.layers import SynthesisLayer
from shgan_torch.ops.bias_act import get_activation, parse_activation
from shgan_torch.ops.modulated_conv import modulated_conv2d
from shgan_torch.ops.noise import noise_key, random_noise
from shgan_torch.ops.noise_bias_act import (epilogue_act, noise_bias_act,
                                            noise_bias_act_cuda,
                                            noise_bias_act_plain)
from test_torch_models import RES, _nonzero_noise_and_bias, tiny_cfg

ACTS = {
    "linear": None,
    "lrelu": "lrelu_agc(alpha=0.2, gain=sqrt_2)",
    "lrelu_clamp": "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)",
}
SEED, LAYER = 5, 17


def _case(dtype, r=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, 4, r, r, generator=g) * 40).to(dtype)
    w = torch.randn(6, 4, 3, 3, generator=g)
    s = torch.randn(2, 4, generator=g) + 1.0
    bias = torch.randn(6, generator=g) * 0.3
    const = torch.randn(r, r, generator=g)
    strength = torch.tensor(0.4)
    return x, w, s, bias, const, strength


def _todays_chain(x, w, s, bias, const, strength, mode, demod, spec, gain):
    """The synthesis layer's chain before the fused epilogue: the noise
    scaled, then modulated_conv2d's addcmul, ``+ bias``, the activation."""
    noise = None
    if mode == "random":
        noise = random_noise(SEED, LAYER, x.shape[0], x.shape[2], "cpu") \
            * strength
    elif mode == "const":
        noise = const * strength
    y = modulated_conv2d(x, w, s, noise=noise, padding=1, demodulate=demod)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None, None]
    act = get_activation(spec)
    if act is not None:
        return act(y, gain=gain)
    return y * gain if gain != 1.0 else y


@pytest.mark.parametrize("gain", [1.0, 0.6])
@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("demod", [True, False])
@pytest.mark.parametrize("mode", ["random", "const", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_todays_chain(dtype, mode, demod, with_bias, act, gain):
    x, w, s, bias, const, strength = _case(dtype)
    bias = bias if with_bias else None
    want = _todays_chain(x, w, s, bias, const, strength, mode, demod,
                         ACTS[act], gain)
    y, dcoefs = modulated_conv2d(x, w, s, padding=1, demodulate=demod,
                                 split_dcoefs=True)
    assert (dcoefs is None) == (not demod)
    got = noise_bias_act(
        y, dcoefs, bias, epilogue_act(parse_activation(ACTS[act]), gain),
        noise_mode=mode, noise_key=noise_key(SEED, LAYER),
        noise_const=const, strength=strength)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_plain_keeps_nan_and_clamps():
    """NaN passes the leaky ReLU and the clamp (torch.where and torch.clamp
    keep it); finite values are clamped to ±256·gain."""
    x = torch.tensor([[[[np.nan, 1e4], [-1e2, -0.0]]]])
    act = epilogue_act(parse_activation(ACTS["lrelu_clamp"]), 0.5)
    y = noise_bias_act_plain(x, act=act)
    assert torch.isnan(y[0, 0, 0, 0])
    assert float(y[0, 0, 0, 1]) == pytest.approx(128.0)
    assert float(y[0, 0, 1, 0]) == pytest.approx(-1e2 * 0.2 * 2 ** 0.5 / 2)
    assert str(float(y[0, 0, 1, 1])) == "-0.0"


def test_epilogue_act_parses_lrelu_and_linear():
    assert epilogue_act(None, 0.5) == (None, 0.5, None)
    alpha, g, c = epilogue_act(parse_activation(ACTS["lrelu_clamp"]), 0.5)
    assert (alpha, c) == (0.2, 128.0) and g == pytest.approx(2 ** 0.5 / 2)
    with pytest.raises(ValueError, match="lrelu_agc or a linear"):
        epilogue_act(parse_activation("sine(freq=3.0)"))
    with pytest.raises(ValueError, match="lrelu_agc or a linear"):
        SynthesisLayer(4, 4, 3, 8, resolution=8, activation="relu")


def test_argument_checks():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="noise_mode"):
        noise_bias_act(x, noise_mode="uniform")
    with pytest.raises(ValueError, match="needs a strength"):
        noise_bias_act(x, noise_mode="const", noise_const=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="noise_key"):
        noise_bias_act(x, noise_mode="random", strength=torch.tensor(1.0))
    with pytest.raises(ValueError, match="H == W"):
        noise_bias_act(torch.zeros(1, 2, 4, 6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        noise_bias_act_cuda(x)
    with pytest.raises(ValueError, match="leaves the noise"):
        modulated_conv2d(x, torch.zeros(2, 2, 3, 3), torch.ones(1, 2),
                         noise=torch.zeros(4, 4), padding=1,
                         split_dcoefs=True)


def _jax_layer_pair(up, spec, seed):
    r = 8
    kw = dict(resolution=r, activation=spec, up=up,
              resample_filter=(1, 3, 3, 1))
    jl = JaxSynthesisLayer(4, 6, 3, 8, **kw)
    flat = params_to_flat_state_dict(jl.init(jax.random.key(seed)))
    flat["noise_strength"] = np.float32(0.3)
    flat["bias"] = (np.random.RandomState(seed).randn(6) * 0.1).astype(
        np.float32)
    tl = SynthesisLayer(4, 6, 3, 8, layer_id=2 * r, **kw)
    tl.load_state_dict(params_from_jax(flat), strict=True)
    return jl, torch_state_dict_to_params(flat), tl


@pytest.mark.parametrize("gain", [1.0, 0.5])
@pytest.mark.parametrize("spec", [ACTS["lrelu"], ACTS["lrelu_clamp"]])
@pytest.mark.parametrize("mode", ["const", "none"])
@pytest.mark.parametrize("up", [1, 2])
def test_synthesis_layer_matches_jax(up, mode, spec, gain):
    jl, jp, tl = _jax_layer_pair(up, spec, seed=up)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 8 // up, 8 // up).astype(np.float32)
    w = rng.randn(2, 8).astype(np.float32)
    want = np.asarray(jl(jp, jnp.asarray(x), jnp.asarray(w), gain=gain,
                         noise_mode=mode))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(w), gain=gain,
                 noise_mode=mode).numpy()
    assert got.shape == want.shape == (2, 6, 8, 8)
    err = np.abs(got - want).max()
    assert err <= 1e-3, f"max abs err {err}"


def test_synthesis_layer_random_noise_reaches_output():
    """Random mode: the epilogue draws the layer's K1 stream; another seed
    gives another output, the same seed the same bits."""
    tl = SynthesisLayer(4, 6, 3, 8, resolution=8, layer_id=16)
    with torch.no_grad():
        tl.noise_strength.fill_(0.3)
        x, w = torch.randn(2, 4, 8, 8), torch.randn(2, 8)
        a = tl(x, w, noise_seed=1)
        b = tl(x, w, noise_seed=1)
        c = tl(x, w, noise_seed=2)
        with pytest.raises(ValueError, match="noise_seed"):
            tl(x, w)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_generator_without_noise_matches_jax():
    """The tiny generator of test_torch_models with noise_mode='none': every
    synthesis layer's epilogue without the noise term."""
    cfg = tiny_cfg()
    jg = jax_get_model(cfg)
    flat = _nonzero_noise_and_bias(
        params_to_flat_state_dict(jg.init(jax.random.key(2))))
    tg = get_model(cfg)
    tg.load_state_dict(params_from_jax(flat), strict=True)
    rng = np.random.RandomState(8)
    real = rng.randn(2, 3, RES, RES).astype(np.float32)
    mask = (rng.rand(2, 1, RES, RES) > 0.4).astype(np.float32)
    x = np.concatenate([mask - 0.5, real * mask], axis=1)
    z = rng.randn(2, 32).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, x, z: jg(p, x, z, noise_mode="none"))(
            torch_state_dict_to_params(flat), jnp.asarray(x),
            jnp.asarray(z)))
    with torch.no_grad():
        got = tg(torch.from_numpy(x), torch.from_numpy(z),
                 noise_mode="none").numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-3, f"max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_at_a_row_offset_are_rows_of_the_larger_draw(dtype):
    """``row0 = k``: the forward, the grad's full and mask-only modes and
    the noise itself equal rows k... of the ``row0 = 0`` versions on a
    batch of k more rows, bit for bit (a rank's block of a global batch
    draws what the one-device batch draws for those rows)."""
    from shgan_torch.ops import noise_bias_act as nba
    from shgan_torch.ops.noise import philox_normal_plain
    k, r = 3, 8
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(k + 2, 4, r, r, generator=g) * 40).to(dtype)
    dy = torch.randn(x.shape, generator=g).to(dtype)
    dcoefs = torch.rand(k + 2, 4, generator=g) + 0.5
    kw = dict(bias=torch.randn(4, generator=g),
              act=epilogue_act(parse_activation(ACTS["lrelu_clamp"]), 0.7),
              noise_mode="random", noise_key=noise_key(SEED, LAYER),
              strength=torch.tensor(0.3))
    key = kw["noise_key"]
    np.testing.assert_array_equal(philox_normal_plain(key, 2, r, row0=k),
                                  philox_normal_plain(key, k + 2, r)[k:])
    whole = nba.noise_bias_act_plain(x, dcoefs, **kw)
    part = nba.noise_bias_act_plain(x[k:], dcoefs[k:], row0=k, **kw)
    np.testing.assert_array_equal(part.float(), whole[k:].float())
    gw = nba.noise_bias_act_grad_plain(dy, x, dcoefs, **kw)
    gp = nba.noise_bias_act_grad_plain(dy[k:], x[k:], dcoefs[k:], row0=k,
                                       **kw)
    np.testing.assert_array_equal(gp[0].float(), gw[0][k:].float())
    np.testing.assert_array_equal(gp[1], gw[1][k:])
    mw = nba.noise_bias_act_mask_plain(dy, x, dcoefs, vs=torch.tensor(0.4),
                                       **kw)
    mp = nba.noise_bias_act_mask_plain(dy[k:], x[k:], dcoefs[k:],
                                       vs=torch.tensor(0.4), row0=k, **kw)
    np.testing.assert_array_equal(mp.float(), mw[k:].float())
    # and the offset moves the draw
    assert not torch.equal(nba.noise_bias_act_plain(x[k:], dcoefs[k:], **kw),
                           part)


def test_row_offset_through_the_layer_and_its_gradient():
    """A ``SynthesisLayer`` at ``row0 = 2`` on the last rows of a batch:
    its output and the gradient of its input are those rows of the whole
    batch's (the style mean taken over the whole batch by a gather that
    hands the rows to one worker: here the batch itself)."""
    from shgan_torch.parallel import Rows

    class Whole:
        """A group of one worker that holds the whole batch's rows."""

        def __init__(self, full):
            self.full = full

        def gather_rows(self, t, rows):
            return torch.cat([self.full[:rows.start], t,
                              self.full[rows.stop:]])

    torch.manual_seed(0)
    layer = SynthesisLayer(4, 6, 3, w_dim=8, resolution=8, up=1,
                           activation=ACTS["lrelu_clamp"], layer_id=16)
    with torch.no_grad():
        layer.noise_strength.fill_(0.2)
    x = torch.randn(5, 4, 8, 8, requires_grad=True)
    w = torch.randn(5, 8)
    whole = layer(x, w, noise_mode="random", noise_seed=11)
    gx, = torch.autograd.grad(whole[2:].square().sum(), x)
    styles = layer.affine(w).detach()
    xp = x[2:].detach().requires_grad_(True)
    part = layer(xp, w[2:], noise_mode="random", noise_seed=11, row0=2,
                 rows=Rows(2, 5, 5, Whole(styles)))
    np.testing.assert_allclose(part.detach(), whole[2:].detach(), rtol=1e-6,
                               atol=1e-6)
    gp, = torch.autograd.grad(part.square().sum(), xp)
    np.testing.assert_allclose(gp, gx[2:], rtol=1e-5, atol=1e-6)
