"""The ops of the training path on the CPU against shgan_tpu: K2's gradient
and second order (the upfirdn2d module), the fused synthesis epilogue's
first and second order, ``minibatch_std`` and the tiny discriminator.

The same numpy inputs go through the JAX function and its port.  On the
CPU the port runs each kernel's plain version under the same
``autograd.Function`` that launches the kernel on the card; the kernels
themselves are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import params_to_flat_state_dict
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.ops import fir_pallas
from shgan_tpu.ops.bias_act import lrelu_agc as jax_lrelu_agc
from shgan_tpu.ops.minibatch_std import minibatch_std as jax_mbstd
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.models import get_model
from shgan_torch.ops import noise_bias_act as nba
from shgan_torch.ops.bias_act import parse_activation
from shgan_torch.ops.minibatch_std import minibatch_std
from shgan_torch.ops.noise import noise_key, philox_normal_plain

jup = importlib.import_module("shgan_tpu.ops.upfirdn2d")
tup = importlib.import_module("shgan_torch.ops.upfirdn2d")

ACT = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
TOL = 1e-5

# the numpy-oracle case list of tests/test_upfirdn2d.py
CASES = [
    dict(up=1, down=1, padding=0),
    dict(up=2, down=1, padding=1),
    dict(up=1, down=2, padding=1),
    dict(up=2, down=1, padding=[2, 1, 1, 2]),
    dict(up=1, down=1, padding=[-1, 2, 0, -2]),
    dict(up=2, down=2, padding=2),
    dict(up=(2, 1), down=(1, 2), padding=[1, 1, 2, 2]),
    dict(up=1, down=1, padding=0, flip_filter=True),
    dict(up=2, down=1, padding=2, gain=4.0),
]


@pytest.fixture(params=["xla", "interpret"])
def fir_impl(request):
    """The JAX reference's route: XLA, or the TPU kernel in the Pallas
    interpreter (stride-1 calls; its VJP is the XLA adjoint)."""
    prev = fir_pallas.get_fir_impl()
    fir_pallas.set_fir_impl(request.param)
    yield request.param
    fir_pallas.set_fir_impl(prev)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


def _fir_case(case, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 8, 9).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1])
    y_shape = np.asarray(jup.upfirdn2d(jnp.asarray(x), f, **case)).shape
    dy = rng.randn(*y_shape).astype(np.float32)
    u = rng.randn(*x.shape).astype(np.float32)
    return x, f, dy, u


@pytest.mark.parametrize("case", CASES)
def test_upfirdn2d_gradient_matches_jax_vjp(fir_impl, case):
    x, f, dy, _ = _fir_case(case)
    _, vjp = jax.vjp(lambda t: jup.upfirdn2d(t, f, **case), jnp.asarray(x))
    want, = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tup.upfirdn2d(xt, tup.setup_filter([1, 3, 3, 1]), **case)
    got, = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    _close(got.numpy(), want, what="dx")


@pytest.mark.parametrize("case", CASES)
def test_upfirdn2d_second_order_matches_jax(case):
    """An R1-shaped second order: the gradient of ``|d s / d x|^2`` with
    ``s = sum(w * tanh(upfirdn2d(x)))``, so K2's backward is itself
    differentiated (its backward is K2 once more).  XLA route: JAX cannot
    linearize the Pallas call inside a second derivative."""
    x, f, dy, u = _fir_case(case, seed=1)
    w = dy

    def s_jax(t):
        return (jnp.asarray(w) * jnp.tanh(jup.upfirdn2d(t, f, **case))).sum()

    def pen_jax(t):
        return (jnp.square(jax.grad(s_jax)(t)) * jnp.asarray(u)).sum()

    want = jax.grad(pen_jax)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tup.upfirdn2d(xt, tup.setup_filter([1, 3, 3, 1]), **case)
    s = (torch.from_numpy(w) * torch.tanh(y)).sum()
    g, = torch.autograd.grad(s, xt, create_graph=True)
    pen = (g.square() * torch.from_numpy(u)).sum()
    got, = torch.autograd.grad(pen, xt)
    _close(got.numpy(), want, what="d2")


@pytest.mark.parametrize("case", CASES)
def test_upfirdn2d_backward_of_backward_matches_jax(fir_impl, case):
    """d/d dy of <dx(dy), u>: the backward differentiated once more, against
    JAX's VJP of its own VJP (the custom VJP's adjoint on the Pallas
    route)."""
    x, f, dy, u = _fir_case(case, seed=2)
    _, vjp = jax.vjp(lambda t: jup.upfirdn2d(t, f, **case), jnp.asarray(x))
    _, vjp2 = jax.vjp(lambda g: vjp(g)[0], jnp.asarray(dy))
    want, = vjp2(jnp.asarray(u))
    xt = torch.from_numpy(x).requires_grad_(True)
    dyt = torch.from_numpy(dy).requires_grad_(True)
    y = tup.upfirdn2d(xt, tup.setup_filter([1, 3, 3, 1]), **case)
    dx, = torch.autograd.grad(y, xt, dyt, create_graph=True)
    assert dx.shape == xt.shape
    got, = torch.autograd.grad((dx * torch.from_numpy(u)).sum(), dyt)
    _close(got.numpy(), want, what="adjoint of adjoint")


@pytest.mark.parametrize("shape,taps,up,down,pads", [
    ((1, 2, 7, 5), (1, 3), (1, 2), (2, 1), (0, -1, 2, 1)),
    ((2, 1, 6, 6), (4, 2), (2, 2), (1, 1), (-2, 3, 1, 0)),
    ((1, 3, 9, 4), (2, 4), (1, 1), (2, 2), (3, 0, -1, 2)),
])
def test_grad_pads_match_autograd_of_plain(shape, taps, up, down, pads):
    """Signed pads, odd sizes, uneven taps: the Function's gradient equals
    autograd of the plain upfirdn2d."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    t = rng.randn(*taps).astype(np.float32)
    xa = x.clone().requires_grad_(True)
    ya = tup.fir_plain(xa, t, up, down, pads)
    dy = torch.from_numpy(rng.randn(*ya.shape).astype(np.float32))
    want, = torch.autograd.grad(ya, xa, dy)
    xb = x.clone().requires_grad_(True)
    yb = tup.fir(xb, t, up, down, pads)
    assert yb.grad_fn is not None and yb.shape == ya.shape
    got, = torch.autograd.grad(yb, xb, dy)
    _close(got.numpy(), want.numpy(), what="dx")


# ---------------------------------------------------------------------------
# the fused epilogue: first and second order against JAX autodiff
# ---------------------------------------------------------------------------

EPI_ACTS = {"linear": None,
            "lrelu": "lrelu_agc(alpha=0.2, gain=sqrt_2)",
            "lrelu_clamp": ACT}


def _epi_case(mode, seed, n=2, c=3, r=8):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: np.asarray(rng.randn(*s), np.float32)  # noqa: E731
    # a wide spread: some elements pass the clamp (256 / sqrt 2)
    x = f32(n, c, r, r) * 60
    d = f32(n, c) * 0.5 + 1.0
    b = f32(c) * 0.3
    s = np.float32(0.7)
    const = f32(r, r)
    key = noise_key(11, 16)
    nu = None
    if mode == "random":
        nu = philox_normal_plain(key, n, r).numpy()[:, None]
    elif mode == "const":
        nu = const
    cot = [f32(n, c, r, r), f32(n, c, r, r), f32(n, c), f32(c), f32()]
    return x, d, b, s, const, key, nu, cot


def _jax_chain(act):
    alpha, gain, clamp = act

    def chain(x, d, b, s, nu):
        pre = x * d[:, :, None, None] + b[None, :, None, None]
        if nu is not None:
            pre = pre + jnp.asarray(nu) * s
        if alpha is None:
            return pre * gain
        return jax_lrelu_agc(pre, alpha=alpha, gain=gain, clamp=clamp)
    return chain


def _torch_args(x, d, b, s, const, key, mode):
    ts = [torch.from_numpy(np.array(v)).requires_grad_(True)
          for v in (x, d, b, s)]
    kw = dict(noise_mode=mode, noise_key=key if mode == "random" else None,
              noise_const=torch.from_numpy(const) if mode == "const" else None)
    return ts, kw


@pytest.mark.parametrize("act_name", list(EPI_ACTS))
@pytest.mark.parametrize("mode", ["random", "const", "none"])
def test_epilogue_gradient_matches_jax(mode, act_name):
    act = nba.epilogue_act(parse_activation(EPI_ACTS[act_name]), 1.0)
    x, d, b, s, const, key, nu, cot = _epi_case(mode, 0)
    chain = _jax_chain(act)
    _, vjp = jax.vjp(lambda *a: chain(*a, nu), jnp.asarray(x),
                     jnp.asarray(d), jnp.asarray(b), jnp.asarray(s))
    want = vjp(jnp.asarray(cot[0]))
    (xt, dt, bt, st), kw = _torch_args(x, d, b, s, const, key, mode)
    y = nba.noise_bias_act(xt, dt, bt, act, strength=st, **kw)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(chain(x, d, b, s, nu)), rtol=1e-6,
        atol=1e-4)
    got = torch.autograd.grad(y, (xt, dt, bt, st), torch.from_numpy(cot[0]),
                              allow_unused=True)
    for name, g, w in zip(("dx", "dd", "db", "ds"), got, want):
        if name == "ds" and mode == "none":
            assert g is None
            continue
        _close(g.numpy(), w, what=name)


@pytest.mark.parametrize("act_name", list(EPI_ACTS))
@pytest.mark.parametrize("mode", ["random", "const", "none"])
def test_epilogue_second_order_matches_jax(mode, act_name):
    """F = <the epilogue's VJP at cotangent v, u>; its gradient in (x, d, b,
    s, v) is the grad kernel's backward (the path-length penalty's)."""
    act = nba.epilogue_act(parse_activation(EPI_ACTS[act_name]), 1.0)
    x, d, b, s, const, key, nu, cot = _epi_case(mode, 1)
    v, ux, ud, ub, us = cot
    chain = _jax_chain(act)

    def f_jax(x, d, b, s, v):
        _, vjp = jax.vjp(lambda *a: chain(*a, nu), x, d, b, s)
        gx, gd, gb, gs = vjp(v)
        out = (gx * ux).sum() + (gd * ud).sum() + (gb * ub).sum()
        return out + (gs * us if nu is not None else 0.0)

    want = jax.grad(f_jax, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t) for t in (x, d, b, s, v)))
    (xt, dt, bt, st), kw = _torch_args(x, d, b, s, const, key, mode)
    vt = torch.from_numpy(v).requires_grad_(True)
    y = nba.noise_bias_act(xt, dt, bt, act, strength=st, **kw)
    gx, gd, gb, gs = torch.autograd.grad(y, (xt, dt, bt, st), vt,
                                         create_graph=True, allow_unused=True)
    f = ((gx * torch.from_numpy(ux)).sum() + (gd * torch.from_numpy(ud)).sum()
         + (gb * torch.from_numpy(ub)).sum())
    if gs is not None:
        f = f + gs * torch.from_numpy(us)
    got = torch.autograd.grad(f, (xt, dt, bt, st, vt), allow_unused=True)
    for name, g, w in zip(("x", "d", "b", "s", "v"), got, want):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        _close(g, w, what=name)


def test_epilogue_third_order_raises():
    act = nba.epilogue_act(parse_activation(ACT), 1.0)
    x, d, b, s, const, key, _, cot = _epi_case("const", 2)
    (xt, dt, bt, st), kw = _torch_args(x, d, b, s, const, key, "const")
    vt = torch.from_numpy(cot[0]).requires_grad_(True)
    y = nba.noise_bias_act(xt, dt, bt, act, strength=st, **kw)
    gx, = torch.autograd.grad(y, xt, vt, create_graph=True)
    g2, = torch.autograd.grad((gx * xt).sum(), vt, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g2.sum(), vt)


def test_epilogue_routes_by_grad_mode():
    """No gradient wanted: the in-place path (the serving launch); a
    gradient wanted: a new tensor with the differentiable Function."""
    act = nba.epilogue_act(parse_activation(ACT), 1.0)
    x, d, b, s, const, key, _, _ = _epi_case("random", 3)
    (xt, dt, bt, st), kw = _torch_args(x, d, b, s, const, key, "random")
    y = nba.noise_bias_act(xt, dt, bt, act, strength=st, **kw)
    assert type(y.grad_fn).__name__ == "_EpilogueBackward"
    with torch.no_grad():
        y2 = nba.noise_bias_act(xt, dt, bt, act, strength=st, **kw)
    assert y2.grad_fn is None
    torch.testing.assert_close(y.detach(), y2, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["random", "const", "none"])
def test_grad_plain_is_autograd_of_the_plain_chain(mode):
    """The grad kernel's plain version (its oracle on the card) equals
    autograd of noise_bias_act_plain."""
    act = nba.epilogue_act(parse_activation(ACT), 1.0)
    x, d, b, s, const, key, _, cot = _epi_case(mode, 4)
    (xt, dt, bt, st), kw = _torch_args(x, d, b, s, const, key, mode)
    y = nba.noise_bias_act_plain(xt, dt, bt, act, strength=st, **kw)
    want = torch.autograd.grad(y, (xt, dt, bt, st), torch.from_numpy(cot[0]),
                               allow_unused=True)
    got = nba.noise_bias_act_grad_plain(
        torch.from_numpy(cot[0]), xt.detach(), dt.detach(), bt.detach(), act,
        strength=st.detach(), **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        _close(g.numpy(), w.numpy(), what="grad")


# ---------------------------------------------------------------------------
# minibatch_std and the discriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,group,f", [(4, 4, 1), (8, 4, 1), (6, 2, 2),
                                       (2, 4, 1)])
def test_minibatch_std_matches_jax(n, group, f):
    x = np.random.RandomState(n).randn(n, 4, 5, 5).astype(np.float32)
    want = np.asarray(jax_mbstd(jnp.asarray(x), group, f))
    got = minibatch_std(torch.from_numpy(x), group, f).numpy()
    _close(got, want, what="mbstd")


def test_minibatch_std_refuses_a_ragged_group():
    with pytest.raises(ValueError, match="multiple"):
        minibatch_std(torch.zeros(6, 2, 4, 4), 4, 1)


def tiny_d_cfg(res=32):
    return {"type": "comodgan_discriminator",
            "args": dict(resolution=res, ic_n=4, ch_base=256, ch_max=8,
                         use_fp16_before_res=None, activation=ACT,
                         mbstd_group_size=4, mbstd_c_n=1)}


def test_tiny_discriminator_matches_jax():
    cfg = tiny_d_cfg()
    jd = jax_get_model(cfg)
    jp = jd.init(jax.random.key(3))
    flat = params_to_flat_state_dict(jp)
    rng = np.random.RandomState(5)
    flat = {k: (np.asarray(v) + (rng.randn(*np.shape(v)) * 0.1
                                 if k.endswith(".bias") else 0)
                ).astype(np.float32) for k, v in flat.items()}
    from shgan_tpu.checkpoint import torch_state_dict_to_params
    jp = torch_state_dict_to_params(flat)
    td = get_model(cfg)
    td.load_state_dict(params_from_jax(flat), strict=True)
    img = rng.randn(4, 4, 32, 32).astype(np.float32)
    want = np.asarray(jd(jp, jnp.asarray(img)))
    got = td(torch.from_numpy(img))
    assert got.shape == (4, 1)
    _close(got.detach().numpy(), want, tol=1e-4, what="logits")
    # and its input gradient (R1's first order)
    it = torch.from_numpy(img).requires_grad_(True)
    g, = torch.autograd.grad(td(it).sum(), it)
    gw = jax.grad(lambda t: jd(jp, t).sum())(jnp.asarray(img))
    _close(g.numpy(), gw, tol=1e-4, what="d logits / d img")
