"""The bf16 throughput configuration of the port (blocks above 16² in
bfloat16) against shgan_tpu on the CPU, at tiny widths.

bf16 rounds at other places in XLA's CPU backend and in PyTorch, so the
port is held to JAX's own bf16 error, never to a fixed tolerance and never
bf16 to bf16: on the same inputs and weights, with ``jax_f32`` JAX in
float32, ``jax_bf16`` JAX in the bf16 configuration and ``port_bf16`` the
port in it,

    ‖port_bf16 − jax_f32‖ ≤ 2 · ‖jax_bf16 − jax_f32‖ + 1e-3     (‖·‖: L2)

for every module that holds a kernel (the synthesis layer: K2 and the
fused epilogue; the encoder block and the D block: K2), for the whole
generator, for the uint8 composite (with the GATE of
``tests/test_bf16_quality.py`` as the outer limit) and for each leaf of one
Gmain + Dmain + R1 gradient at batch 2.  Measured ratios
``‖port_bf16 − jax_f32‖ / ‖jax_bf16 − jax_f32‖`` when these tests were
written: synthesis layer 0.94 (up 2) and 0.94 (up 1), encoder block 1.02 /
1.01 (x / skip feature), D block 1.19, generator 1.06, composite 1.26
(max uint8 Δ 7, PSNR 54.9 dB, SSIM 0.999994), gradient leaves at most 1.64
(median about 1).

The gradient runs with oneDNN off on the port's side: PyTorch's oneDNN
bf16 convolution gives a wrong double backward on the CPU at some shapes
(the weight gradient of a 3×3 conv at [2, 8, 32, 32] through R1 comes out
~20× too small; ``torch.backends.mkldnn.enabled = False`` gives the right
one), a fault of the CPU library, not of the port's bf16 path; the card
runs cuDNN.
"""

import copy
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import (params_to_flat_state_dict,
                                  torch_state_dict_to_params)
from shgan_tpu.eval.ssim import compute_ssim
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.models.discriminator import DiscrimBlock as JaxDBlock
from shgan_tpu.models.encoder import EncoderBlock as JaxEBlock
from shgan_tpu.models.infer import composite_forward as jax_composite
from shgan_tpu.models.infer import z_for_positions as jax_z
from shgan_tpu.models.layers import SynthesisLayer as JaxSynthesisLayer
from shgan_tpu.train import loss as JL
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.main import build_config, run
from shgan_torch.models import get_model
from shgan_torch.models.discriminator import DiscrimBlock
from shgan_torch.models.encoder import EncoderBlock
from shgan_torch.models.layers import SynthesisLayer
from shgan_torch.ops import noise_bias_act as nba
from shgan_torch.ops.bias_act import parse_activation
from shgan_torch.serve import InpaintEngine
from shgan_torch.train import TrainConfig, TrainStep
from shgan_torch.train import loss as TL
from test_bf16_quality import GATE
from test_torch_models import _nonzero_noise_and_bias, tiny_cfg
from test_torch_train import _flat, _with_biases
from test_torch_train_ops import tiny_d_cfg

fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
ACT = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
RES = 64          # the generator and composite tests: 32² and 64² in bf16
GRAD_RES = 32     # the gradient test, with bf16 above 8²: 16² and 32²


def _norm(a):
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def within_twice_jax(port_bf16, jax_bf16, jax_f32, what=""):
    """‖port_bf16 − jax_f32‖ ≤ 2 ‖jax_bf16 − jax_f32‖ + 1e-3; returns the
    ratio of the two errors."""
    ref = _f32(jax_f32)
    port = _norm(_f32(port_bf16) - ref)
    own = _norm(_f32(jax_bf16) - ref)
    assert port <= 2 * own + 1e-3, (what, port, own)
    return port / max(own, 1e-12)


def bf16_cfg(cfg, thr=16):
    cfg = copy.deepcopy(cfg)
    cfg["args"]["encoder"]["args"]["use_fp16_before_res"] = thr
    cfg["args"]["synthesis"]["args"]["use_fp16_after_res"] = thr
    return cfg


# -- the modules that hold a kernel -------------------------------------------


@pytest.mark.parametrize("up", [2, 1])
def test_synthesis_layer_bf16_within_twice_jax(up):
    """K2 (up = 2) and the fused epilogue with the layer's noise_const."""
    res = 32 if up == 2 else 16
    rf = [1, 3, 3, 1] if up == 2 else None
    jl = JaxSynthesisLayer(16, 16, 3, 32, resolution=res, activation=ACT,
                           up=up, resample_filter=rf)
    flat = _nonzero_noise_and_bias(
        params_to_flat_state_dict(jl.init(jax.random.key(1))))
    tl = SynthesisLayer(16, 16, 3, 32, resolution=res, activation=ACT,
                        up=up, resample_filter=rf)
    tl.load_state_dict(params_from_jax(flat), strict=True)
    jp = torch_state_dict_to_params(flat)
    rng = np.random.RandomState(up)
    x = rng.randn(2, 16, 16, 16).astype(np.float32)
    w = rng.randn(2, 32).astype(np.float32)
    f = jax.jit(lambda p, x, w: jl(p, x, w, noise_mode="const"))
    j32 = f(jp, jnp.asarray(x), jnp.asarray(w))
    jbf = f(jp, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    with torch.no_grad():
        got = tl(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                 noise_mode="const")
    assert got.dtype == torch.bfloat16 and jbf.dtype == jnp.bfloat16
    within_twice_jax(got, jbf, j32, f"synthesis layer up {up}")


@pytest.mark.parametrize("which", ["encoder", "discriminator"])
def test_encoder_and_d_block_bf16_within_twice_jax(which):
    """K2's down = 2 blurs (and the D block's skip) in a bf16 block."""
    J, T = ((JaxEBlock, EncoderBlock) if which == "encoder"
            else (JaxDBlock, DiscrimBlock))
    kw = dict(rgb_n=4, resample_filter=[1, 3, 3, 1], activation=ACT)
    j32, jbf = J(8, 8, 16, **kw, use_fp16=False), J(8, 8, 16, **kw,
                                                      use_fp16=True)
    flat = _nonzero_noise_and_bias(
        params_to_flat_state_dict(j32.init(jax.random.key(2))))
    jp = torch_state_dict_to_params(flat)
    tb = T(8, 8, 16, **kw, use_fp16=True)
    tb.load_state_dict(params_from_jax(flat), strict=True)
    img = np.random.RandomState(3).randn(2, 4, 32, 32).astype(np.float32)
    w32 = jax.jit(lambda p, i: j32(p, None, i))(jp, jnp.asarray(img))
    wbf = jax.jit(lambda p, i: jbf(p, None, i))(jp, jnp.asarray(img))
    with torch.no_grad():
        got = tb(None, torch.from_numpy(img))
    if which == "encoder":   # (x down 2, the skip feature)
        for g, b, a in zip(got, wbf, w32):
            assert g.dtype == torch.bfloat16
            within_twice_jax(g, b, a, "encoder block")
    else:
        assert got.dtype == torch.bfloat16
        within_twice_jax(got, wbf[0], w32[0], "D block")


# -- the generator, the engine and the composite ------------------------------


@pytest.fixture(scope="module")
def weights():
    """A tiny SH-GAN at 64² with moved biases and noise strengths: (JAX
    f32 model, JAX bf16 model, flat weights)."""
    cfg = tiny_cfg(RES)
    jg = jax_get_model(cfg)
    flat = _nonzero_noise_and_bias(
        params_to_flat_state_dict(jg.init(jax.random.key(4))), 5)
    return jg, jax_get_model(bf16_cfg(cfg)), flat


def _request(n=4, seed=1):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, 3, RES, RES), dtype=np.uint8)
    masks = (rng.rand(n, RES, RES) > 0.4).astype(np.float32)
    return imgs, masks


def test_generator_bf16_within_twice_jax(weights):
    jg, jgb, flat = weights
    jp = torch_state_dict_to_params(flat)
    imgs, masks = _request()
    x = np.concatenate([masks[:, None] - 0.5,
                        (imgs / 127.5 - 1) * masks[:, None]], 1).astype(
        np.float32)
    z = np.random.RandomState(2).randn(4, 32).astype(np.float32)
    fwd = lambda g: jax.jit(lambda p, x, z: g(p, x, z, noise_mode="const"))
    j32 = fwd(jg)(jp, jnp.asarray(x), jnp.asarray(z))
    jbf = fwd(jgb)(jp, jnp.asarray(x), jnp.asarray(z))
    tg = get_model(bf16_cfg(tiny_cfg(RES)))
    tg.load_state_dict(params_from_jax(flat), strict=True)
    assert tg.synthesis.b64.dtype == tg.encoder.b64.dtype == torch.bfloat16
    assert tg.synthesis.b16.dtype == tg.encoder.b16.dtype == torch.float32
    with torch.no_grad():
        got = tg(torch.from_numpy(x), torch.from_numpy(z), noise_mode="const")
    assert got.dtype == torch.float32   # the image pyramid stays float32
    within_twice_jax(got, jbf, j32, "generator")


def _gate(got, ref):
    """The four numbers of tests/test_bf16_quality.py's GATE."""
    got, ref = got.astype(np.int64), ref.astype(np.int64)
    delta = np.abs(got - ref)
    mse = float(((got - ref) ** 2).mean()) / 255 ** 2
    psnr = float("inf") if mse == 0 else -10 * np.log10(mse)
    ssim = float(np.mean(compute_ssim(ref / 255.0, got / 255.0)))
    return {"max_u8_delta": int(delta.max()), "psnr": psnr, "ssim": ssim,
            "frac_gt2": float((delta > 2).mean())}


def test_bf16_engine_composite_within_twice_jax_and_gate(weights):
    """The port's bf16 engine against JAX's composite in float32 and in
    bf16 on the same weights, z and masks (noise const): the uint8 error
    within twice JAX's own, and inside the GATE."""
    jg, jgb, flat = weights
    jp = torch_state_dict_to_params(flat)
    imgs, masks = _request()
    z = jnp.asarray(jax_z(7, 32, range(4)))
    real = jnp.asarray(imgs)
    mask = jnp.asarray(masks[:, None])
    comp = lambda g: np.asarray(jax.jit(lambda p, r, m, z: jax_composite(
        g, p, r, m, z, None, noise_mode="const"))(jp, real, mask, z))
    j32, jbf = comp(jg), comp(jgb)
    e = InpaintEngine(tiny_cfg(RES), batch_size=4, seed=7, bf16=True,
                      noise_mode="const", device="cpu")
    e.G.load_state_dict(params_from_jax(flat), strict=True)
    got = e.inpaint(imgs, masks)
    assert got.dtype == np.uint8 and got.shape == imgs.shape
    within_twice_jax(got.astype(np.float32), jbf.astype(np.float32),
                     j32.astype(np.float32), "composite")
    g = _gate(got, j32)
    assert g["max_u8_delta"] <= GATE["max_u8_delta"], g
    assert g["psnr"] >= GATE["min_psnr"], g
    assert g["ssim"] >= GATE["min_ssim"], g
    assert g["frac_gt2"] <= GATE["max_frac_gt2"], g


def test_bf16_engine_keeps_the_callers_cfg():
    """``bf16=True`` works on a deep copy: the caller's dict stays float32,
    and a float32 engine built later from it is float32."""
    cfg = tiny_cfg(32)
    before = copy.deepcopy(cfg)
    e = InpaintEngine(cfg, batch_size=2, bf16=True, device="cpu")
    assert cfg == before
    assert e.G.synthesis.b32.dtype == e.G.encoder.b32.dtype == torch.bfloat16
    f = InpaintEngine(cfg, batch_size=2, device="cpu")
    assert f.G.synthesis.b32.dtype == f.G.encoder.b32.dtype == torch.float32
    # parameters stay float32 in both
    assert {p.dtype for p in e.G.parameters()} == {torch.float32}


# -- the gradient ----------------------------------------------------------------


def _grad_cfgs(bf):
    g = copy.deepcopy(tiny_cfg(GRAD_RES))
    g["args"]["encoder"]["args"]["use_dropout"] = False
    d = tiny_d_cfg(GRAD_RES)
    d["args"]["mbstd_group_size"] = 2
    if bf:
        g = bf16_cfg(g, 8)
        d["args"]["use_fp16_before_res"] = 8
    return g, d


@pytest.mark.parametrize("net", ["G", "D"])
def test_bf16_gradient_within_twice_jax(net):
    """One Gmain gradient of G, or one Dmain + R1 gradient of D, at batch 2,
    each leaf within twice JAX's own bf16 error (+ 1e-3) of JAX's float32
    gradient; style mixing, dropout and the noise strengths off, so the
    draws that differ by design drop out (noise_strength leaves left out:
    they are sums of the noise)."""
    n = 2
    fg = _with_biases(_flat(jax_get_model(_grad_cfgs(0)[0]).init(
        jax.random.key(0))), 1)
    fd = _with_biases(_flat(jax_get_model(_grad_cfgs(0)[1]).init(
        jax.random.key(1))), 2)
    pg, pd = torch_state_dict_to_params(fg), torch_state_dict_to_params(fd)
    rng = np.random.RandomState(0)
    real = (rng.randn(n, 3, GRAD_RES, GRAD_RES) * 0.5).astype(np.float32)
    mask = (rng.rand(n, 1, GRAD_RES, GRAD_RES) > 0.4).astype(np.float32)
    x_in = np.concatenate([mask - 0.5, real * mask], 1)
    z = rng.randn(n, 32).astype(np.float32)
    c = jnp.zeros((n, 0))
    a = [jnp.asarray(v) for v in (x_in, mask, real, z)]

    def jax_grad(bf):
        jg, jd = (jax_get_model(m) for m in _grad_cfgs(bf))
        if net == "G":
            f = lambda p: JL.g_main_loss(jg, jd, p, pd, a[0], a[1], a[3], c,
                                         jax.random.key(3), 0.0)[0]
            return _flat(jax.jit(jax.grad(f))(pg))

        def f(p):
            loss = JL.d_main_loss(jg, jd, pg, p, a[0], a[1], a[2], a[3], c,
                                  jax.random.key(4), 0.0)[0]
            return loss + JL.d_r1_loss(jd, p, a[1], a[2], c)[0]
        return _flat(jax.jit(jax.grad(f))(pd))

    j32, jbf = jax_grad(0), jax_grad(1)
    G, D = (get_model(m) for m in _grad_cfgs(1))
    G.load_state_dict(params_from_jax(fg), strict=True)
    D.load_state_dict(params_from_jax(fd), strict=True)
    t = lambda v: torch.from_numpy(np.asarray(v, np.float32))  # noqa: E731
    with torch.backends.mkldnn.flags(enabled=False):
        if net == "G":
            D.requires_grad_(False)
            TL.g_main_loss(G, D, t(x_in), t(mask), t(z),
                           torch.Generator().manual_seed(0), 0.0)[0].backward()
            module = G
        else:
            G.requires_grad_(False)
            loss = TL.d_main_loss(G, D, t(x_in), t(mask), t(real), t(z),
                                  torch.Generator().manual_seed(1), 0.0)[0]
            (loss + TL.d_r1_loss(D, t(mask), t(real))[0]).backward()
            module = D
    seen = 0
    for name, p in module.named_parameters():
        if name.endswith("noise_strength") or p.grad is None:
            continue
        assert p.grad.dtype == torch.float32
        within_twice_jax(p.grad, jbf[name], j32[name], f"{net}.{name}")
        seen += 1
    assert seen > 20


# -- the derivative kernels' plain versions in bf16 -----------------------------


def test_epilogue_differentiates_in_bf16():
    """The differentiable epilogue on a bf16 x: y and dx in bf16, the
    dcoef / bias / strength gradients in float32.  On the same bf16 values
    of x and dy: dx is the float32 dx rounded once (the plain grad widens
    the pair), y within 4 bf16 ulp of the float32 y (the forward chain
    rounds after each of its ops, as JAX's bf16 chain does), the sums and
    the second order within 2e-2 relative (+ 1e-3).  (y's ulp is taken at
    the larger of |y| and |x * dcoef|: the sum can cancel.)"""
    rng = np.random.RandomState(0)
    x32 = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32) * 3)
    x16 = x32.bfloat16()
    act = nba.epilogue_act(parse_activation(ACT))
    d = torch.from_numpy(rng.rand(2, 3).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(3).astype(np.float32) * 0.1)
    s = torch.tensor(0.3)
    cst = torch.from_numpy(rng.randn(8, 8).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32)
                          ).bfloat16()
    outs = {}
    for name, x in (("f32", x16.float()), ("bf16", x16)):
        ins = [t.clone().requires_grad_(True) for t in (x, d, b, s)]
        y = nba.noise_bias_act(*ins[:3], act, noise_mode="const",
                               noise_const=cst, strength=ins[3])
        gs = torch.autograd.grad(y, ins, dy.to(x.dtype), create_graph=True)
        gg = torch.autograd.grad(gs[0].float().square().sum()
                                 + gs[1].square().sum(), ins[:2])
        outs[name] = (y, gs, gg)
    y16, g16, gg16 = outs["bf16"]
    y32, g32, gg32 = outs["f32"]
    assert y16.dtype == g16[0].dtype == gg16[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in g16[1:] + gg16[1:])
    ulp = lambda v: 2.0 ** (torch.floor(torch.log2(  # noqa: E731
        v.abs().clamp_min(1e-30))) - 7)
    y32 = y32.detach()
    scale = torch.maximum(y32.abs(), (x16.float() * d[:, :, None, None]).abs())
    assert ((y16.detach().float() - y32).abs() <= 4 * ulp(scale)).all()
    assert torch.equal(g16[0].detach(), g32[0].detach().bfloat16())
    for got, want in zip(g16[1:] + gg16[1:], g32[1:] + gg32[1:]):
        np.testing.assert_allclose(got.detach().float(), want.detach(),
                                   rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("up,down,pads", [(1, 1, (2, 2, 2, 2)),
                                          (1, 2, (1, 1, 1, 1)),
                                          (2, 1, (2, 1, 2, 1))])
def test_fir_backward_takes_a_bf16_cotangent(up, down, pads):
    """K2's forward, backward and second order on bf16 tensors (the routes
    of a bf16 block: the blur, down = 2, up = 2): each in bf16, within one
    bf16 ulp (+ 1e-6) of the float32 call on the same bf16 values (the
    plain version sums in float32 and rounds once)."""
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]),
                                gain=up * up)
    rng = np.random.RandomState(up + 2 * down)
    bf = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).bfloat16()
    x16 = bf(2, 3, 8, 8)
    oh = fir.out_size(8, up, down, pads[2], pads[3], 4)
    dy16, v16 = bf(2, 3, oh, oh), bf(2, 3, 8, 8)
    res = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xr = x16.to(dt).requires_grad_(True)
        dy = dy16.to(dt).requires_grad_(True)
        y = fir.fir(xr, taps, (up, up), (down, down), pads)
        dx, = torch.autograd.grad(y, xr, dy, create_graph=True)
        ddy, = torch.autograd.grad(dx, dy, v16.to(dt))
        res[name] = (y, dx, ddy)
    for got, want in zip(res["bf16"], res["f32"]):
        assert got.dtype == torch.bfloat16
        want = want.detach()
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 7)
        assert ((got.detach().float() - want).abs() <= ulp + 1e-6).all()


# -- training with bf16 blocks ------------------------------------------------------

BF16_TRAIN = {"model_g.args.encoder.args.use_fp16_before_res": 16,
              "model_g.args.synthesis.args.use_fp16_after_res": 16,
              "model_d.args.use_fp16_before_res": 16}


def _smoke(path, kimg, **kw):
    return build_config("smoke_train", log_root=str(path), overrides={
        "train.experiment_id": 0, "train.total_kimg": kimg, **BF16_TRAIN},
        **kw)


def test_bf16_training_resumes_bit_for_bit(tmp_path):
    """smoke_train with bf16 blocks (``build_config(overrides=...)``, as
    bench.py configures the JAX step): parameters, Adam state and G_ema
    stay float32; six steps in one run equal three, a snapshot and three
    more, bit for bit."""
    whole = run(_smoke(tmp_path / "a", 0.048), device="cpu")
    step = whole["step"]
    assert step.G.synthesis.b32.dtype == torch.bfloat16
    assert step.D.b32.dtype == torch.bfloat16
    for mod in (step.G, step.D, step.G_ema):
        assert {p.dtype for p in mod.parameters()} == {torch.float32}
    for opt in (step.opt_g, step.opt_d):
        assert {v.dtype for st in opt.state.values() for v in st.values()
                if torch.is_tensor(v) and v.ndim} == {torch.float32}
    for t in whole["ticks"]:
        assert np.isfinite([t["loss_g"], t["loss_d"]]).all()
    run(_smoke(tmp_path / "b", 0.024), device="cpu")
    snap = sorted((tmp_path / "b").rglob("network-snapshot-*"))
    rest = run(_smoke(tmp_path / "c", 0.048, resume_path=str(snap[0])),
               device="cpu")["step"]
    assert rest.step == step.step == 6
    for a, b in ((step.G, rest.G), (step.D, rest.D),
                 (step.G_ema, rest.G_ema)):
        for (name, x), (_, y) in zip(a.state_dict().items(),
                                     b.state_dict().items()):
            assert torch.equal(x, y), name


def test_bf16_training_with_grad_accum():
    """``grad_accum`` 2 with bf16 blocks: one step with both regularizers,
    finite losses, every trainable parameter moved."""
    g_cfg, d_cfg = _grad_cfgs(1)
    G, D = get_model(g_cfg, seed=1), get_model(d_cfg, seed=2)
    before = {k: v.clone() for k, v in G.state_dict().items()}
    st = TrainStep(G, D, TrainConfig(grad_accum=2))
    rng = np.random.RandomState(3)
    real = torch.from_numpy(rng.randn(4, 3, GRAD_RES, GRAD_RES).astype(
        np.float32) * 0.5)
    mask = torch.from_numpy((rng.rand(4, 1, GRAD_RES, GRAD_RES) > 0.5
                             ).astype(np.float32))
    m = st(real, mask, torch.Generator().manual_seed(0), 0.99, True, True)
    assert all(torch.isfinite(v) for v in m.values()), m
    moved = [k for k, v in G.state_dict().items()
             if k.endswith("weight") and not torch.equal(v, before[k])]
    assert len(moved) > 20


# -- chip_smoke.py's launch rule for the bf16 path --------------------------------


def _count_by_dtype(monkeypatch):
    """Where each kernel's wrapper would launch it on the card, counted in
    ({kernel: calls}, {kernel: calls on bf16 tensors})."""
    counts, counts16 = {}, {}
    fir_any, on = fir._fir_any, nba._on

    def tally(name, x):
        counts[name] = counts.get(name, 0) + 1
        if x.dtype == torch.bfloat16:
            counts16[name] = counts16.get(name, 0) + 1

    def counted_fir(x, taps, up, down, pads, counter):
        tally(counter, x)
        return fir_any(x, taps, up, down, pads, counter)

    def counted_on(x, cuda_fn, plain_fn):
        fn = on(x, cuda_fn, plain_fn)

        def run(*a, **k):
            tally(nba.kernel_of(k.get("dcoefs"), k.get("noise_mode"))
                  if plain_fn is nba.noise_bias_act_plain
                  else "noise_bias_act_grad", x)
            return fn(*a, **k)
        return run
    monkeypatch.setattr(fir, "_fir_any", counted_fir)
    monkeypatch.setattr(nba, "_on", counted_on)
    return counts, counts16


def _smoke_module():
    import sys
    from test_torch_models import REPO
    sys.path.insert(0, REPO)
    return importlib.import_module("chip_smoke")


def test_chip_smoke_bf16_launch_rule_counts_a_step(monkeypatch):
    """The per-step launch counts chip_smoke.py checks in phase 11, worked
    out from the modules (``train_sites`` over the sites that run in
    bf16), against the calls a bf16 train step makes, by type."""
    smoke = _smoke_module()
    counts, counts16 = _count_by_dtype(monkeypatch)
    g_cfg, d_cfg = _grad_cfgs(1)
    G, D = get_model(g_cfg), get_model(d_cfg)
    step = TrainStep(G, D, TrainConfig())
    sites, sites16 = (smoke.train_sites(G, D, dt)
                      for dt in (None, torch.bfloat16))
    assert sites16[3] == 4 and 0 < sites16[0] < sites[0]
    g = torch.Generator().manual_seed(0)
    real = torch.rand(4, 3, GRAD_RES, GRAD_RES, generator=g) * 2 - 1
    mask = (torch.rand(4, 1, GRAD_RES, GRAD_RES, generator=g) > 0.5).float()
    for greg, dreg in [(True, True), (False, False)]:
        counts.clear()
        counts16.clear()
        with torch.backends.mkldnn.flags(enabled=False):
            step(real, mask, torch.Generator().manual_seed(1), 0.9, greg,
                 dreg)
        want = smoke.expected_train_launches(*sites, greg, dreg)
        assert counts == {k: v for k, v in want.items() if v}
        want16 = smoke.expected_train_launches(*sites16, greg, dreg)
        assert counts16 == {k: v for k, v in want16.items()
                            if v and k in smoke.BF16_KEYS}


def test_chip_smoke_stylegan2_launch_rule(monkeypatch):
    """Phase 11's StyleGAN2 counts: a forward (K2 at the up-convs and the
    skip-image upsamples, the epilogue at every layer) and one
    unconditional_g_main_loss backward, all and bf16, on a small
    StyleGAN2 with its D, bf16 above 8²."""
    smoke = _smoke_module()
    counts, counts16 = _count_by_dtype(monkeypatch)
    from test_torch_stylegan import d_cfg, sg_generator_cfg
    g_cfg, dc = sg_generator_cfg(), d_cfg()
    g_cfg["args"]["synthesis"]["args"]["use_fp16_after_res"] = 8
    dc["args"]["use_fp16_before_res"] = 8
    G, D = get_model(g_cfg), get_model(dc)
    want, want16 = smoke.forward_launches(G, encoder=False)
    z = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        G(z, noise_mode="random", noise_seed=1)
    assert counts == {k: v for k, v in want.items() if v}
    assert counts16 == {k: v for k, v in want16.items() if v}
    assert want16["noise_bias_act"] == 4 and want["noise_bias_act"] == 7
    counts.clear()
    counts16.clear()
    D.requires_grad_(False)
    with torch.backends.mkldnn.flags(enabled=False):
        loss, _ = TL.unconditional_g_main_loss(
            G, D, z, None, torch.Generator().manual_seed(2))
        loss.backward()
    n_syn, layers, _ = smoke.sites_of(G.synthesis)
    n_d, c_d = smoke.sites_of(D)[0], smoke.conv_sites(D)
    assert counts == {"upfirdn2d": n_syn + n_d,
                      "upfirdn2d_grad": n_syn + n_d,
                      "noise_bias_act": layers,
                      "noise_bias_act_grad": layers + c_d,
                      "bias_lrelu": c_d}
    b_syn, b_layers, _ = smoke.sites_of(G.synthesis, torch.bfloat16)
    b_d = smoke.sites_of(D, torch.bfloat16)[0]
    bc_d = smoke.conv_sites(D, torch.bfloat16)
    assert 0 < bc_d < c_d
    assert counts16 == {"upfirdn2d": b_syn + b_d,
                        "upfirdn2d_grad": b_syn + b_d,
                        "noise_bias_act": b_layers,
                        "noise_bias_act_grad": b_layers + bc_d,
                        "bias_lrelu": bc_d}


def test_chip_smoke_serving_sites_match_its_fir_calls():
    """``forward_launches`` of the serving model counts the K2 calls that
    ``fir_calls`` lists for it (phase 3's rule) and the bf16 ones at the
    blocks above 16²."""
    smoke = _smoke_module()
    cfg = tiny_cfg(RES)
    G = get_model(bf16_cfg(cfg))
    want, want16 = smoke.forward_launches(G)
    assert want["upfirdn2d"] == len(smoke.fir_calls(cfg, 2))
    assert want["noise_bias_act"] == sum(smoke.noise_layers(cfg).values())
    assert want["bias_lrelu"] == sum(
        smoke.encoder_conv_layers(cfg).values())
    # bf16: the encoder's 64² and 32² blurs, the synthesis' 32² and 64²
    # up-convs; the epilogue at the four layers of those two blocks;
    # bias_lrelu at the encoder's five convs of those two blocks (b64's
    # fromrgb, conv0 and conv1, b32's conv0 and conv1)
    assert want16 == {"upfirdn2d": 4, "upfirdn2d_grad": 0,
                      "noise_bias_act": 4, "noise_bias_act_grad": 0,
                      "bias_lrelu": 5}
