"""Kernels K1, K2, K3 and the fused synthesis epilogue against their plain
PyTorch versions on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it also runs on a machine that has only the
port's dependencies (from the repository root):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import importlib

import numpy as np
import pytest
import torch

from shgan_torch.kernels import build
from shgan_torch.models.layers import SynthesisLayer
from shgan_torch.ops import conv1024, noise
from shgan_torch.ops import noise_bias_act as nba
from shgan_torch.ops.bias_act import parse_activation
from shgan_torch.serve import InpaintEngine

fir_mod = importlib.import_module("shgan_torch.ops.upfirdn2d")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


FIR_CASES = [
    # (shape, up, down, pads, gain) — the main path's call sites, small C
    ((2, 16, 17, 17), 1, 1, (1, 1, 1, 1), 4),   # synthesis up FIR
    ((2, 16, 16, 16), 1, 1, (2, 2, 2, 2), 1),   # encoder down blur
    ((2, 3, 8, 8), 2, 1, (2, 1, 2, 1), 4),      # skip-image upsample
    ((2, 5, 9, 11), 2, 2, (-1, 2, 0, -2), 1),   # signed pads, both ways
    ((1, 2, 12, 7), 1, 2, (1, 1, 1, 1), 1),
    # the tiled path (up = down = 1): small planes packed 8 (<= 16²) or 2
    # (<= 32²) to an item with a partial last group; rows whose 16-byte
    # chunks start at another offset in each row (W not a multiple of 4 or
    # 8); several 64x32 tiles with ragged edges
    ((4, 33, 8, 8), 1, 1, (2, 2, 2, 2), 1),     # encoder blur at 8²
    ((3, 41, 9, 9), 1, 1, (1, 1, 1, 1), 4),     # synthesis up FIR at 8²
    ((2, 7, 30, 30), 1, 1, (2, 2, 2, 2), 1),
    ((2, 8, 33, 65), 1, 1, (1, 1, 1, 1), 4),
    ((1, 4, 70, 130), 1, 1, (2, 2, 2, 2), 1),
    ((1, 3, 129, 257), 1, 1, (1, 1, 1, 1), 4),
]


# the resampling tiles (down = 2, up = 2): D's 1x1 skips of comodgan_d256
# at every resolution with its channel counts (batch 2), down = 2, and
# their backward, up = 2 on the skips' outputs; the skip-image upsample at
# 256² out; odd sizes and signed pads
RESAMPLE_CASES = [
    ((2, 128, 256, 256), 1, 2, (1, 1, 1, 1), 1),
    ((2, 256, 128, 128), 1, 2, (1, 1, 1, 1), 1),
    ((2, 512, 64, 64), 1, 2, (1, 1, 1, 1), 1),
    ((2, 512, 32, 32), 1, 2, (1, 1, 1, 1), 1),
    ((2, 512, 16, 16), 1, 2, (1, 1, 1, 1), 1),
    ((2, 512, 8, 8), 1, 2, (1, 1, 1, 1), 1),
    ((2, 128, 128, 128), 2, 1, (2, 1, 2, 1), 4),
    ((2, 256, 64, 64), 2, 1, (2, 1, 2, 1), 4),
    ((2, 512, 32, 32), 2, 1, (2, 1, 2, 1), 4),
    ((2, 512, 16, 16), 2, 1, (2, 1, 2, 1), 4),
    ((2, 512, 8, 8), 2, 1, (2, 1, 2, 1), 4),
    ((2, 512, 4, 4), 2, 1, (2, 1, 2, 1), 4),
    ((8, 3, 128, 128), 2, 1, (2, 1, 2, 1), 4),
    ((3, 7, 37, 29), 1, 2, (-1, 2, 3, -2), 1),
    ((3, 7, 19, 13), 2, 1, (2, 1, 2, 1), 4),
    ((2, 5, 45, 67), 2, 1, (0, 2, -2, 1), 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,down,pads,gain",
                         FIR_CASES + RESAMPLE_CASES)
def test_upfirdn2d_kernel_matches_plain(cuda, dtype, shape, up, down, pads,
                                        gain):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    taps = fir_mod.correlation_taps(fir_mod.setup_filter([1, 3, 3, 1]),
                                    gain=gain)
    got = fir_mod.fir_cuda(x, taps, (up, up), (down, down), pads)
    want = fir_mod.fir_plain(x.float(), taps, (up, up), (down, down), pads)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        # float32 sums rounded once to bf16: one bf16 ulp of the plain
        # result, plus 1e-6 for the float32 sums' order near zero
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 7)
        assert ((got.float() - want).abs() <= ulp + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,taps,pads,offset,up,down", [
    ((2, 3, 21, 37), (3, 5), (-1, 2, 2, 0), 0, 1, 1),
    ((2, 9, 13, 13), (8, 8), (3, 4, 4, 3), 0, 1, 1),
    ((1, 2, 70, 67), (8, 8), (1, 2, 3, 0), 0, 1, 1),
    ((2, 5, 17, 19), (4, 4), (1, 1, 1, 1), 1, 1, 1),   # 4 bytes off 16
    ((2, 4, 40, 70), (4, 4), (2, 1, 1, 2), 0, 1, 1),   # 4x4, random taps
    # the resampling tiles' general tap loop (other taps; up = 2 with an
    # odd pad), and resampling calls off 16-byte alignment (generic)
    ((2, 3, 35, 33), (3, 5), (2, 1, 0, 3), 0, 1, 2),
    ((2, 9, 40, 23), (8, 8), (3, 4, 4, 3), 0, 1, 2),
    ((2, 3, 17, 9), (3, 5), (-2, 3, 0, -1), 0, 2, 1),
    ((2, 4, 11, 30), (4, 4), (1, 2, 3, 0), 0, 2, 1),
    ((1, 2, 33, 40), (8, 8), (4, 3, 3, 4), 0, 2, 1),
    ((2, 64, 32, 32), (4, 4), (1, 1, 1, 1), 1, 1, 2),
    ((2, 64, 16, 16), (4, 4), (2, 1, 2, 1), 1, 2, 1),
])
def test_upfirdn2d_kernel_other_taps(cuda, dtype, shape, taps, pads, offset,
                                     up, down):
    """The tiled paths with taps other than the main path's, and a tensor
    that starts off the 16-byte alignment its loads need (the generic
    kernel takes it)."""
    g = torch.Generator().manual_seed(2)
    t = torch.randn(taps, generator=g).numpy()
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=g).to(cuda, dtype)
    x = flat[offset:].view(shape)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    f, d = (up, up), (down, down)
    got = fir_mod.fir_cuda(x, t, f, d, pads)
    want = fir_mod.fir_plain(x.float(), t, f, d, pads)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 7)
        assert ((got.float() - want).abs() <= ulp + 1e-6).all()


@pytest.mark.parametrize("res", [4, 8, 64, 512])
def test_noise_kernel_matches_plain(cuda, res):
    key = noise.noise_key(5, 2 * res)
    got = noise.philox_normal_cuda(key, 3, res, cuda)
    want = noise.philox_normal_plain(key, 3, res, cuda)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_wrappers_count_launches_and_refuse_grad(cuda):
    """Each wrapper counts its launches; K2 and the epilogue take tensors
    that need a gradient (K2's derivatives count apart, the epilogue's
    backward is its grad kernel); the in-place epilogue launch and K3 still
    refuse them."""
    build.reset_launches()
    x = torch.randn(1, 2, 8, 8, device=cuda)
    fir_mod.upfirdn2d(x, fir_mod.setup_filter([1, 3, 3, 1]), padding=1)
    noise.random_noise(0, 8, 2, 8, cuda)
    nba.noise_bias_act(torch.zeros(1, 2, 8, 8, device=cuda))
    assert build.launches == {"upfirdn2d": 1, "upfirdn2d_grad": 0,
                              "philox_normal": 1, "conv3x3_lowch": 0,
                              "noise_bias_act": 1, "noise_bias_act_grad": 0}
    xg = torch.zeros(1, 2, 8, 8, device=cuda, requires_grad=True)
    y = nba.noise_bias_act(xg)
    assert y.data_ptr() != xg.data_ptr()
    y.sum().backward()
    assert build.launches["noise_bias_act"] == 2
    assert build.launches["noise_bias_act_grad"] == 1
    with pytest.raises(RuntimeError, match="in-place"):
        nba.noise_bias_act_cuda(xg)
    y = fir_mod.upfirdn2d(x.requires_grad_(), fir_mod.setup_filter([1, 3]))
    y.sum().backward()
    assert build.launches["upfirdn2d"] == 2
    assert build.launches["upfirdn2d_grad"] == 1
    with pytest.raises(RuntimeError):
        conv1024.conv3x3_lowch(torch.zeros(1, 4, 8, 8, device=cuda,
                                           requires_grad=True),
                               torch.zeros(4, 4, 3, 3, device=cuda))


@pytest.mark.parametrize("shape,up,down,pads,gain",
                         FIR_CASES + RESAMPLE_CASES)
def test_upfirdn2d_backward_matches_autograd_of_plain(cuda, shape, up, down,
                                                      pads, gain):
    """K2's backward and an R1-shaped second order (|d s/dx|² differentiated
    once more) against autograd of fir_plain on the card, float32, 1e-5."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g).to(cuda)
    taps = fir_mod.correlation_taps(fir_mod.setup_filter([1, 3, 3, 1]),
                                    gain=gain)
    args = (taps, (up, up), (down, down), pads)

    def run(fn):
        xa = x.clone().requires_grad_(True)
        y = fn(xa, *args)
        w = torch.randn(y.shape, generator=g.manual_seed(2)).to(cuda)
        d1, = torch.autograd.grad((w * torch.tanh(y)).sum(), xa,
                                  create_graph=True)
        d2, = torch.autograd.grad(d1.square().sum(), xa)
        return d1.detach(), d2

    build.reset_launches()
    got = run(fir_mod.fir)
    assert build.launches["upfirdn2d"] == 1
    assert build.launches["upfirdn2d_grad"] == 3
    for a, b in zip(got, run(fir_mod.fir_plain)):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 1e-5 * scale


GRAD_SHAPES = [(4, 512), (8, 64), (16, 7), (64, 33), (256, 4), (6, 3)]


@pytest.mark.parametrize("mode", ["random", "const", "none"])
@pytest.mark.parametrize("res,c", GRAD_SHAPES)
def test_noise_bias_act_grad_kernel_matches_plain(cuda, mode, res, c):
    """The grad kernel's full mode against its plain version on the card:
    dx within 4 ulp (plus the noise term where the normals are drawn), the
    sums within 1e-5 of the sum of their terms' magnitudes."""
    spec, gain = NBA_ACTS[(res + c) % 3]
    n = 2
    x, dcoefs, bias, const, strength = _nba_inputs(cuda, torch.float32, n,
                                                   c, res, seed=res + c)
    x = x.nan_to_num()
    dy = torch.randn(x.shape, device=cuda)
    act = nba.epilogue_act(parse_activation(spec), gain)
    kw = dict(dcoefs=dcoefs, bias=bias, act=act, noise_mode=mode,
              noise_key=noise.noise_key(5, 2 * res), noise_const=const,
              strength=strength)
    build.reset_launches()
    got = nba.noise_bias_act_grad_cuda(dy, x, **kw)
    torch.cuda.synchronize()
    assert build.launches["noise_bias_act_grad"] == 1
    want = nba.noise_bias_act_grad_plain(dy, x, **kw)
    e = torch.floor(torch.log2(want[0].abs().clamp_min(1e-30)))
    tol = 4 * 2.0 ** (e - 23)
    assert ((got[0] - want[0]).abs() <= tol).all()
    g = nba.noise_bias_act_mask_plain(dy, x, **kw).double()
    nu = nba._noise_plain(x, mode, kw["noise_key"], const)
    terms = [(got[1], (g * x).abs().sum((2, 3)), want[1]),
             (got[2], g.abs().sum((0, 2, 3)), want[2])]
    if mode != "none":
        terms.append((got[3], (g * nu).abs().sum(), want[3]))
    else:
        assert got[3] is None
    for a, mag, b in terms:
        assert ((a.double() - b.double()).abs() <= 1e-5 * mag + 1e-30).all()


@pytest.mark.parametrize("mode", ["random", "const", "none"])
def test_noise_bias_act_double_backward_matches_autograd_of_plain(cuda,
                                                                  mode):
    """The differentiable epilogue on the card, first and second order (the
    grad kernel in both modes) against autograd of noise_bias_act_plain on
    the same device."""
    n, c, res = 2, 6, 16
    x, dcoefs, bias, const, strength = _nba_inputs(cuda, torch.float32, n,
                                                   c, res, seed=7)
    x = x.nan_to_num()
    act = nba.epilogue_act(parse_activation(NBA_ACTS[1][0]), 1.0)
    v = torch.randn(x.shape, device=cuda)
    u = [torch.randn(t.shape, device=cuda) for t in (x, dcoefs, bias)]

    def run(fn):
        ins = [t.clone().requires_grad_(True)
               for t in (x, dcoefs, bias, strength, v)]
        y = fn(ins[0], ins[1], ins[2], act, noise_mode=mode,
               noise_key=noise.noise_key(5, 32), noise_const=const,
               strength=ins[3])
        gs = torch.autograd.grad(y, ins[:3], ins[4], create_graph=True)
        f = sum((a * b).sum() for a, b in zip(gs, u))
        return [t.detach() for t in gs] + list(torch.autograd.grad(
            f, [ins[0], ins[1], ins[4]]))

    build.reset_launches()
    got = run(nba.noise_bias_act)
    assert build.launches["noise_bias_act_grad"] == 3
    for a, b in zip(got, run(nba.noise_bias_act_plain)):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 1e-5 * scale
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,o,h,w", [
    (2, 32, 32, 64, 64), (1, 32, 32, 33, 70), (1, 5, 3, 13, 21),
    (1, 12, 32, 17, 130),
    # O < 32 on the 16-byte path; C over two bf16 stages and three float32
    # ones; a ragged W (not a multiple of 4) over many tiles
    (1, 32, 20, 40, 96), (1, 17, 32, 24, 72), (2, 32, 32, 19, 1030)])
def test_conv3x3_lowch_kernel_matches_plain(cuda, dtype, n, c, o, h, w):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, c, h, w, generator=g).to(cuda, dtype)
    wt = (torch.randn(o, c, 3, 3, generator=g) / (9 * c) ** 0.5).to(cuda)
    build.reset_launches()
    got = conv1024.conv3x3_lowch(x, wt)
    assert build.launches["conv3x3_lowch"] == 1
    # the plain version in float32 on the same inputs: x as given, and the
    # weights rounded to x's dtype, as the wrapper hands them to the kernel
    wr = wt.to(dtype).float()
    want = conv1024.conv3x3_lowch_plain(x.float(), wr)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 7)
        assert ((got.float() - want).abs() <= ulp + 1e-6).all()
    lib = torch.nn.functional.conv2d(x.float(), wr, padding=1)
    torch.testing.assert_close(want, lib, rtol=0, atol=1e-4)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv1024.conv3x3_lowch(x.float().requires_grad_(), wt)


def test_tiny_engine_card_matches_cpu(cuda):
    """The tiny engine with const noise on the card and on the CPU."""
    act = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    enc = dict(resolution=32, ic_n=4, oc_n=32, ch_base=256, ch_max=8,
               use_fp16_before_res=None, activation=act, mbstd_group_size=0,
               mbstd_c_n=0, has_extra_final_layer=False, shu_input_res=16,
               shu_lowest_res=4, shu_channels=4, shu_df_freedom=[2, 3])
    cfg = {"type": "comodgan_generator", "args": {
        "mapping": {"type": "comodgan_mapping",
                    "args": dict(z_dim=32, w_dim=32, num_ws=8, num_layers=2)},
        "encoder": {"type": "shgan_encoder", "args": enc},
        "synthesis": {"type": "comodgan_synthesis",
                      "args": dict(w_dim=32, w0_dim=32, resolution=32,
                                   ch_base=256, ch_max=8,
                                   use_fp16_after_res=None)}}}
    kw = dict(batch_size=2, seed=1, noise_mode="const")
    a = InpaintEngine(cfg, device=cuda, **kw)
    b = InpaintEngine(cfg, device="cpu", **kw)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (3, 3, 32, 32), dtype=np.uint8)
    masks = (rng.rand(3, 32, 32) > 0.5).astype(np.float32)
    d = np.abs(a.inpaint(imgs, masks).astype(int)
               - b.inpaint(imgs, masks).astype(int))
    assert d.max() <= 1


NBA_ACTS = [
    # (spec, runtime gain): linear with a gain, lrelu with and without clamp
    (None, 0.5),
    ("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)", 1.0),
    ("lrelu_agc(alpha=0.2, gain=sqrt_2)", 0.7),
]
NOISE_ATOL = 1e-4   # K1 vs its plain version: logf/sincosf rounding


def _nba_inputs(cuda, dtype, n, c, res, seed, offset=0):
    """x (with a NaN, ±0 and values past the clamp), dcoefs, bias, const
    plane, strength; ``offset`` elements shift x off the 16-byte alignment
    (the kernel's one-call-a-thread path)."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(n * c * res * res + offset, generator=g) * 100
    flat[offset + 5], flat[offset + 6], flat[offset + 7] = np.nan, -0.0, 0.0
    x = flat.to(cuda, dtype)[offset:].view(n, c, res, res)
    dcoefs = (torch.rand(n, c, generator=g) + 0.5).to(cuda)
    bias = (torch.randn(c, generator=g) * 0.3).to(cuda)
    const = torch.randn(res, res, generator=g).to(cuda)
    strength = torch.tensor(0.3, device=cuda)
    return x, dcoefs, bias, const, strength


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["random", "const", "none"])
@pytest.mark.parametrize("res,c", [(4, 512), (4, 3), (8, 7), (8, 64),
                                   (64, 33), (64, 64), (512, 5), (512, 4)])
def test_noise_bias_act_kernel_matches_plain(cuda, dtype, mode, res, c):
    """float32: within 4 ulp of the plain result plus the noise term's
    NOISE_ATOL·strength·gain; bf16: within one bf16 ulp of the plain result
    in float32 on the bf16 input (plus the same noise term)."""
    spec, gain = NBA_ACTS[(res + c) % 3]
    demod, with_bias = c % 2 == 1 or res == 4, c != 64
    n = 2
    x, dcoefs, bias, const, strength = _nba_inputs(
        cuda, dtype, n, c, res, seed=res * 1000 + c,
        offset=2 if res == 8 else 0)
    act = nba.epilogue_act(parse_activation(spec), gain)
    kw = dict(dcoefs=dcoefs if demod else None,
              bias=bias if with_bias else None, act=act, noise_mode=mode,
              noise_key=noise.noise_key(5, 2 * res), noise_const=const,
              strength=strength)
    want = nba.noise_bias_act_plain(x.float(), **kw)
    build.reset_launches()
    got = nba.noise_bias_act(x, **kw)
    torch.cuda.synchronize()
    assert build.launches["noise_bias_act"] == 1
    assert got.data_ptr() == x.data_ptr() and got.dtype == dtype
    got = got.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    got, want = got[ok], want[ok]
    noise_tol = NOISE_ATOL * 0.3 * act[1] if mode == "random" else 0.0
    e = torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
    ulp = 2.0 ** (e - (7 if dtype == torch.bfloat16 else 23))
    tol = ulp * (1 if dtype == torch.bfloat16 else 4) + noise_tol
    assert ((got - want).abs() <= tol).all(), float((got - want).abs().max())


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("demod", [True, False])
@pytest.mark.parametrize("res", [4, 8, 64, 512])
def test_noise_bias_act_noise_is_k1_bit_for_bit(cuda, res, demod, offset):
    """x = 0, strength 1, no bias, linear, gain 1: the output is K1's noise,
    bit for bit, broadcast over the channels (offset 2: the kernel's
    one-call-a-thread path)."""
    n, c = 3, 5
    flat = torch.zeros(n * c * res * res + offset, device=cuda)
    x = flat[offset:].view(n, c, res, res)
    key = noise.noise_key(9, 2 * res)
    got = nba.noise_bias_act(
        x, (torch.rand(n, c, device=cuda) + 0.5) if demod else None,
        noise_mode="random", noise_key=key,
        strength=torch.ones((), device=cuda))
    want = noise.philox_normal_cuda(key, n, res, cuda)[:, None]
    torch.cuda.synchronize()
    assert torch.equal(got, want.expand_as(got))


def test_noise_bias_act_kernel_keeps_nan_and_refuses_layouts(cuda):
    act = nba.epilogue_act(parse_activation(NBA_ACTS[1][0]), 0.5)
    x = torch.tensor([np.nan, 1e4, -1e4, -0.0] * 4, device=cuda).view(
        1, 1, 4, 4)
    y = nba.noise_bias_act(x.clone(), act=act).cpu()
    want = nba.noise_bias_act_plain(x.cpu(), act=act)
    assert torch.equal(torch.isnan(y), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(y[ok], want[ok]) and float(y.nan_to_num().max()) == 128
    with pytest.raises(ValueError, match="contiguous"):
        nba.noise_bias_act(torch.zeros(1, 4, 4, 2, device=cuda).permute(
            0, 3, 1, 2))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        nba.noise_bias_act(torch.zeros(1, 2, 4, 4, device=cuda).half())
    with pytest.raises(ValueError, match="dcoefs"):
        nba.noise_bias_act(torch.zeros(1, 2, 4, 4, device=cuda),
                           torch.ones(1, 3, device=cuda))


@pytest.mark.parametrize("mode", ["random", "const", "none"])
@pytest.mark.parametrize("up", [1, 2])
def test_synthesis_layer_card_matches_cpu(cuda, up, mode):
    """A SynthesisLayer on the card (conv, then the fused epilogue: one
    launch) against the same layer on the CPU."""
    torch.manual_seed(0)
    layer = SynthesisLayer(16, 24, 3, 8, resolution=32, up=up, layer_id=64,
                           activation="lrelu_agc(alpha=0.2, gain=sqrt_2, "
                                      "clamp=256)").requires_grad_(False)
    layer.noise_strength.fill_(0.3)
    layer.bias.copy_(torch.randn(24) * 0.2)
    x, w = torch.randn(2, 16, 32 // up, 32 // up), torch.randn(2, 8)
    want = layer(x, w, gain=0.7, noise_mode=mode, noise_seed=3)
    layer.to(cuda)
    build.reset_launches()
    got = layer(x.to(cuda), w.to(cuda), gain=0.7, noise_mode=mode,
                noise_seed=3).cpu()
    assert build.launches["noise_bias_act"] == 1
    assert build.launches["philox_normal"] == 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
