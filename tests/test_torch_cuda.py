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


GRAD_SHAPES = [(4, 512), (8, 64), (16, 7), (64, 33), (256, 4), (6, 3),
               # the grad kernel's blocks of 8 and of 4 channels, the last
               # group partial (noise_bias_act.cuh: grad_group)
               (4, 4091), (32, 2045)]


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


def test_device_timeit_times_cuda_with_events(cuda):
    """``device_timeit`` on a CUDA result times the calls with CUDA events
    (a positive mean that covers the queued work), and on a CPU result
    with the host clock."""
    from shgan_torch.utils import device_timeit
    x = torch.randn(2048, 2048, device=cuda)
    t = device_timeit(lambda a: a @ a, x, iters=4, warmup=1)
    assert 0 < t < 10
    assert device_timeit(lambda a: a + 1, torch.ones(8), iters=2) > 0


@pytest.mark.parametrize("optimizer", [
    {"type": "adam", "args": {"betas": [0.0, 0.99], "weight_decay": 0.01}},
    {"type": "sgd", "args": {"momentum": 0.9, "nesterov": True}}])
def test_scheduled_optimizer_on_card_equals_cpu(cuda, optimizer):
    """A registry optimizer with a warm-up schedule steps CUDA parameters as
    it steps the same CPU parameters (the NaN scrub included), each update
    at the same LR: within 1e-6 relative after five updates."""
    from shgan_torch.train import make_optimizer, nan_scrub, optimizer_step
    sched = [{"type": "linear", "args": {"start_lr": 0.0, "end_lr": 2e-3,
                                         "step": 3}},
             {"type": "constant", "args": {"lr": 2e-3, "step": 10}}]
    g = torch.Generator().manual_seed(0)
    init = [torch.randn(64, 33, generator=g), torch.randn(7, generator=g)]
    runs = {}
    for dev in ("cpu", cuda):
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = make_optimizer(ps, reg_interval=4, optimizer=optimizer,
                             schedule=sched)
        gg = torch.Generator().manual_seed(1)
        for k in range(5):
            for p in ps:
                p.grad = torch.randn(p.shape, generator=gg).to(dev)
            ps[0].grad[0, :3] = torch.tensor([float("nan"), float("inf"),
                                              -float("inf")])
            nan_scrub(ps)
            optimizer_step(opt, k)
        runs[str(dev)] = ([p.detach().cpu() for p in ps],
                          [grp["lr"] for grp in opt.param_groups])
    (cpu_p, cpu_lr), (card_p, card_lr) = runs["cpu"], runs[str(cuda)]
    assert cpu_lr == card_lr
    for a, b in zip(card_p, cpu_p):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# -- the bf16 path: the grad kernel and K2's derivatives in bf16, the bf16
#    engine ----------------------------------------------------------------


def _bf16_ulp(v):
    return 2.0 ** (torch.floor(torch.log2(v.float().abs().clamp_min(1e-30)))
                   - 7)


@pytest.mark.parametrize("mode", ["random", "const", "none"])
@pytest.mark.parametrize("res,c", GRAD_SHAPES)
def test_noise_bias_act_grad_kernel_bf16_matches_plain(cuda, mode, res, c):
    """The grad kernel with bf16 dy and x: the full mode's dx (bf16) within
    one bf16 ulp of the plain version's (the widened pair's float32 dx
    rounded once; the noise drawn by K1 for both), its float32 sums within
    1e-5 of the sum of their terms' magnitudes; the mask-only mode's
    output within one bf16 ulp; the regenerated noise K1's rounded to bf16,
    bit for bit."""
    spec, gain = NBA_ACTS[(res + c) % 3]
    n = 2
    x, dcoefs, bias, const, strength = _nba_inputs(cuda, torch.bfloat16, n,
                                                   c, res, seed=res + c + 1)
    x = x.nan_to_num()
    dy = torch.randn(x.shape, device=cuda).bfloat16()
    key = noise.noise_key(6, 2 * res)
    act = nba.epilogue_act(parse_activation(spec), gain)
    kw = dict(dcoefs=dcoefs, bias=bias, act=act, noise_mode=mode,
              noise_key=key, noise_const=const, strength=strength)
    orig = nba.philox_normal_plain
    nba.philox_normal_plain = (lambda k, b, r, device="cpu", row0=0:
                               noise.philox_normal_cuda(k, b, r, device,
                                                        row0))
    try:
        build.reset_launches()
        got = nba.noise_bias_act_grad_cuda(dy, x, **kw)
        m_got = nba.noise_bias_act_mask_cuda(dy, x, **kw)
        torch.cuda.synchronize()
        assert build.launches["noise_bias_act_grad"] == 2
        want = nba.noise_bias_act_grad_plain(dy, x, **kw)
        m_want = nba.noise_bias_act_mask_plain(dy, x, **kw)
        g = nba.noise_bias_act_mask_plain(dy.float(), x.float(),
                                          **kw).double()
        nu = nba._noise_plain(x, mode, key, const)
    finally:
        nba.philox_normal_plain = orig
    assert got[0].dtype == m_got.dtype == torch.bfloat16
    for a, b in ((got[0], want[0]), (m_got, m_want)):
        assert ((a.float() - b.float()).abs() <= _bf16_ulp(b)).all()
    xd = x.double()
    terms = [(got[1], (g * xd).abs().sum((2, 3)), want[1]),
             (got[2], g.abs().sum((0, 2, 3)), want[2])]
    if mode != "none":
        terms.append((got[3], (g * nu).abs().sum(), want[3]))
    for a, mag, b in terms:
        assert a.dtype == torch.float32
        assert ((a.double() - b.double()).abs() <= 1e-5 * mag + 1e-30).all()
    if mode == "random":
        zero = torch.zeros_like(x)
        nu_k = nba.noise_bias_act_mask_cuda(
            zero, zero, noise_mode="random", noise_key=key,
            strength=torch.ones((), device=cuda),
            vs=torch.ones((), device=cuda))
        k1 = noise.philox_normal_cuda(key, n, res, cuda)[:, None]
        assert torch.equal(nu_k, k1.bfloat16().expand_as(nu_k))


@pytest.mark.parametrize("mode", ["random", "const"])
def test_bf16_epilogue_first_and_second_order_card_matches_cpu(cuda, mode):
    """The differentiable epilogue on bf16 x (the grad kernel in both modes
    on the card) against the same on the CPU (the plain versions), with
    const noise bit for bit the same plane, random noise K1's vs torch's
    normals: first and second order within one bf16 ulp (+ 1e-5 of the
    largest value for the float32 sums)."""
    n, c, res = 2, 6, 16
    x, dcoefs, bias, const, strength = _nba_inputs(cuda, torch.bfloat16, n,
                                                   c, res, seed=9)
    x = x.nan_to_num()
    act = nba.epilogue_act(parse_activation(NBA_ACTS[1][0]), 1.0)
    v = torch.randn(x.shape, device=cuda).bfloat16()
    u = [torch.randn(t.shape, device=cuda).to(t.dtype)
         for t in (x, dcoefs, bias)]

    def run(dev):
        ins = [t.to(dev).clone().requires_grad_(True)
               for t in (x, dcoefs, bias, strength, v)]
        y = nba.noise_bias_act(ins[0], ins[1], ins[2], act, noise_mode=mode,
                               noise_key=noise.noise_key(5, 32),
                               noise_const=const.to(dev), strength=ins[3])
        gs = torch.autograd.grad(y, ins[:3], ins[4], create_graph=True)
        f = sum((a.float() * b.to(dev).float()).sum()
                for a, b in zip(gs, u))
        return [t.detach().cpu() for t in gs] + [
            t.cpu() for t in torch.autograd.grad(f, [ins[0], ins[1],
                                                     ins[4]])]

    build.reset_launches()
    got = run(cuda)
    assert build.launches["noise_bias_act_grad"] == 3
    for a, b in zip(got, run("cpu")):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            tol = 2 * _bf16_ulp(b) + (1e-3 if mode == "random" else 0)
            assert ((a.float() - b.float()).abs() <= tol).all()
        else:
            scale = max(float(b.abs().max()), 1.0)
            assert float((a - b).abs().max()) <= 2e-2 * scale


@pytest.mark.parametrize("shape,up,down,pads,gain",
                         FIR_CASES + RESAMPLE_CASES)
def test_upfirdn2d_bf16_backward_matches_autograd_of_plain(cuda, shape, up,
                                                           down, pads, gain):
    """K2's forward, backward and second order on bf16 tensors, on every
    route ``fir_route`` picks (the cases above cover the stride-1 tiles,
    the resampling tiles and the generic kernel), against autograd of
    fir_plain on the same bf16 values: each within one bf16 ulp + 1e-6."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to(cuda).bfloat16()
    taps = fir_mod.correlation_taps(fir_mod.setup_filter([1, 3, 3, 1]),
                                    gain=gain)
    args = (taps, (up, up), (down, down), pads)

    def run(fn):
        xa = x.clone().requires_grad_(True)
        y = fn(xa, *args)
        dy = torch.randn(y.shape, generator=g.manual_seed(4)).to(
            cuda).bfloat16().requires_grad_(True)
        dx, = torch.autograd.grad(y, xa, dy, create_graph=True)
        w = torch.randn(x.shape, generator=g.manual_seed(5)).to(
            cuda).bfloat16()
        ddy, = torch.autograd.grad(dx, dy, w)
        return y.detach(), dx.detach(), ddy

    build.reset_launches()
    got = run(fir_mod.fir)
    assert build.launches["upfirdn2d"] == 1
    assert build.launches["upfirdn2d_grad"] == 2
    for a, b in zip(got, run(fir_mod.fir_plain)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert ((a.float() - b.float()).abs() <= _bf16_ulp(b) + 1e-6).all()


def test_bf16_engine_gate_on_a_small_model(cuda):
    """A small SH-GAN at 128² served with ``bf16=True`` against the float32
    engine on the same weights (noise const, TF32 off): the launches of a
    forward (K2 and the epilogue, some in bf16), and the composite inside
    tests/test_bf16_quality.py's GATE."""
    from test_bf16_quality import GATE
    from shgan_torch.eval.ssim import compute_ssim
    act = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    enc = dict(resolution=128, ic_n=4, oc_n=64, ch_base=2048, ch_max=32,
               use_fp16_before_res=None, activation=act, mbstd_group_size=0,
               mbstd_c_n=0, has_extra_final_layer=False, shu_input_res=32,
               shu_lowest_res=4, shu_channels=8, shu_df_freedom=[2, 3])
    cfg = {"type": "comodgan_generator", "args": {
        "mapping": {"type": "comodgan_mapping",
                    "args": dict(z_dim=64, w_dim=64, num_ws=12,
                                 num_layers=2)},
        "encoder": {"type": "shgan_encoder", "args": enc},
        "synthesis": {"type": "comodgan_synthesis",
                      "args": dict(w_dim=64, w0_dim=64, resolution=128,
                                   ch_base=2048, ch_max=32,
                                   use_fp16_after_res=None)}}}
    kw = dict(batch_size=4, seed=2, noise_mode="const", device=cuda)
    e32 = InpaintEngine(cfg, **kw)
    e16 = InpaintEngine(cfg, bf16=True, **kw)
    assert cfg["args"]["synthesis"]["args"]["use_fp16_after_res"] is None
    assert e16.G.synthesis.b128.dtype == torch.bfloat16
    with torch.no_grad():
        for e in (e32, e16):
            for name, p in e.G.named_parameters():
                if name.endswith("noise_strength"):
                    p.fill_(0.1)
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (4, 3, 128, 128), dtype=np.uint8)
    masks = (rng.rand(4, 128, 128) > 0.5).astype(np.float32)
    a = e32.inpaint(imgs, masks)
    build.reset_launches()
    b = e16.inpaint(imgs, masks)
    # K2: the encoder's 5 blurs, 5 up-convs and 5 skip-image upsamples;
    # the epilogue at 11 layers
    assert build.launches["upfirdn2d"] == 15
    assert build.launches["noise_bias_act"] == 11
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    delta = np.abs(a64 - b64)
    mse = float(((a64 - b64) ** 2).mean()) / 255 ** 2
    psnr = float("inf") if mse == 0 else -10 * np.log10(mse)
    ssim = float(compute_ssim(torch.from_numpy(a),
                              torch.from_numpy(b)).mean())
    assert delta.max() <= GATE["max_u8_delta"], delta.max()
    assert psnr >= GATE["min_psnr"] and ssim >= GATE["min_ssim"], (psnr,
                                                                   ssim)
    assert (delta > 2).mean() <= GATE["max_frac_gt2"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_a_row_offset_draw_the_larger_batchs_rows(cuda, dtype):
    """K1, the fused epilogue and its grad kernel (both modes) at ``row0 =
    3``: rows 3... of the ``row0 = 0`` launch on 3 more rows, bit for bit
    (the grad kernel's per-plane sums to rounding: it chunks a plane's sum
    by the batch's size), and the plain version at ``row0 = 3``."""
    k, res = 3, 64
    key = noise.noise_key(8, 2 * res)
    big = noise.philox_normal_cuda(key, k + 2, res, cuda)
    part = noise.philox_normal_cuda(key, 2, res, cuda, row0=k)
    torch.testing.assert_close(part, big[k:], rtol=0, atol=0)
    torch.testing.assert_close(
        part, noise.philox_normal_plain(key, 2, res, cuda, row0=k), rtol=0,
        atol=1e-4)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(k + 2, 16, res, res, device=cuda, generator=g)
         * 3).to(dtype)
    dy = torch.randn(x.shape, device=cuda, generator=g).to(dtype)
    kw = dict(dcoefs=torch.rand(k + 2, 16, device=cuda, generator=g) + 0.5,
              bias=torch.randn(16, device=cuda, generator=g),
              act=nba.epilogue_act(parse_activation(
                  "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")),
              noise_mode="random", noise_key=key,
              strength=torch.full((), 0.3, device=cuda))
    part_kw = dict(kw, dcoefs=kw["dcoefs"][k:].contiguous(), row0=k)
    y_all = nba.noise_bias_act_cuda(x, out=torch.empty_like(x), **kw)
    y_part = nba.noise_bias_act_cuda(x[k:].contiguous(),
                                     out=torch.empty_like(x[k:]), **part_kw)
    gw = nba.noise_bias_act_grad_cuda(dy, x, **kw)
    gp = nba.noise_bias_act_grad_cuda(dy[k:].contiguous(), x[k:].contiguous(),
                                      **part_kw)
    mw = nba.noise_bias_act_mask_cuda(dy, x, **kw)
    mp = nba.noise_bias_act_mask_cuda(dy[k:].contiguous(), x[k:].contiguous(),
                                      **part_kw)
    torch.cuda.synchronize()
    for got, want in ((y_part, y_all[k:]), (gp[0], gw[0][k:]),
                      (mp, mw[k:])):
        assert torch.equal(got, want)
    # d dcoefs: plane sums, chunked by the batch's size (another order)
    torch.testing.assert_close(gp[1], gw[1][k:], rtol=1e-5, atol=1e-5)
    plain = nba.noise_bias_act_plain(x[k:], **part_kw).to(dtype)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y_part.float(), plain.float(), rtol=tol,
                               atol=tol)
