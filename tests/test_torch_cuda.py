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
from shgan_torch.ops import conv1024, conv_resample, noise
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
    nba.noise_bias_act(torch.zeros(1, 2, 8, 8, device=cuda),
                       torch.ones(1, 2, device=cuda))
    assert build.launches == {"upfirdn2d": 1, "upfirdn2d_grad": 0,
                              "philox_normal": 1, "conv3x3_lowch": 0,
                              "noise_bias_act": 1, "noise_bias_act_grad": 0,
                              "bias_lrelu": 1}
    xg = torch.zeros(1, 2, 8, 8, device=cuda, requires_grad=True)
    y = nba.noise_bias_act(xg)
    assert y.data_ptr() != xg.data_ptr()
    y.sum().backward()
    assert build.launches["bias_lrelu"] == 2
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


def _tiny_engine_cfg():
    act = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    enc = dict(resolution=32, ic_n=4, oc_n=32, ch_base=256, ch_max=8,
               use_fp16_before_res=None, activation=act, mbstd_group_size=0,
               mbstd_c_n=0, has_extra_final_layer=False, shu_input_res=16,
               shu_lowest_res=4, shu_channels=4, shu_df_freedom=[2, 3])
    return {"type": "comodgan_generator", "args": {
        "mapping": {"type": "comodgan_mapping",
                    "args": dict(z_dim=32, w_dim=32, num_ws=8, num_layers=2)},
        "encoder": {"type": "shgan_encoder", "args": enc},
        "synthesis": {"type": "comodgan_synthesis",
                      "args": dict(w_dim=32, w0_dim=32, resolution=32,
                                   ch_base=256, ch_max=8,
                                   use_fp16_after_res=None)}}}


def test_compiled_engine_matches_eager(cuda):
    """A small model's one-device engine replays a captured graph per
    bucket: each request equals the eager forward at its own start bit for
    bit, and so does each of six streamed batches at window 2 (read back
    on the copy stream into arrays that share no memory and stay as they
    were after the stream ends); the launch counts are one forward's a
    replay.  The eager forward runs in the compiled forward's layout
    (channels-last): the same kernels, so the same bits."""
    from shgan_torch.data.rng import derive_seed
    from shgan_torch.models.infer import composite_forward, z_for_positions
    from shgan_torch.serve import BATCH_NOISE_SALT
    e = InpaintEngine(_tiny_engine_cfg(), device=cuda, batch_size=2,
                      latency_batches=(1,), seed=1, noise_mode="random")
    with torch.no_grad():
        for name, p in e.G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    assert e.path() == "compiled"
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (2, 3, 32, 32), dtype=np.uint8)
    masks = (rng.rand(2, 32, 32) > 0.5).astype(np.float32)

    def eager(n, start):
        z = z_for_positions(1, e.G.z_dim, range(start, start + n))
        with torch.inference_mode():
            return composite_forward(
                e.G, torch.from_numpy(imgs[:n]).to(cuda),
                torch.from_numpy(masks[:n, None]).to(cuda),
                torch.from_numpy(z).to(cuda),
                noise_seed=derive_seed(1, start, BATCH_NOISE_SALT),
                memory_format=torch.channels_last).cpu().numpy()

    e.inpaint(imgs, masks)            # captures bucket 2
    torch.cuda.synchronize()
    build.reset_launches()
    outs = {st: e.inpaint(imgs, masks, start_index=st) for st in (0, 5, 9)}
    one = e.inpaint(imgs[:1], masks[:1], start_index=3)   # bucket 1
    torch.cuda.synchronize()
    per = {k: v // 4 for k, v in build.launches.items()}
    assert per["noise_bias_act"] == 7 and per["upfirdn2d"] > 0
    assert build.launches == {k: 4 * v for k, v in per.items()}
    for st, out in outs.items():
        np.testing.assert_array_equal(out, eager(2, st))
    np.testing.assert_array_equal(one, eager(1, 3))
    assert not np.array_equal(outs[0], outs[5])
    streamed, first = [], []
    for got in e.inpaint_stream(iter([(imgs, masks)] * 6), start_index=20,
                                window=2):
        streamed.append(got)
        first.append(got.copy())
    assert len(streamed) == 6
    for i, got in enumerate(streamed):
        np.testing.assert_array_equal(got, eager(2, 20 + 2 * i))
    # later readbacks take other pinned blocks: the arrays stay as they were
    list(e.inpaint_stream(iter([(imgs, masks)] * 3), window=2))
    for got, was in zip(streamed, first, strict=True):
        np.testing.assert_array_equal(got, was)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(streamed)
                   for b in streamed[i + 1:])
    assert len(e.compiled.records) == 2 and e.compiled.pool_bytes() >= 0
    e.close()
    assert not e.compiled.statics


def test_engine_route_replays_k3_on_the_card(cuda, monkeypatch):
    """shgan_g1024's plan at a tiny width (2 channels at 1024²): the engine
    replays a graph with K3's two launches; captured again with the route
    swapped for the library conv it replays none, and the two composites
    agree within a level (K3 against cuDNN, TF32 off)."""
    import copy
    from shgan_torch.runtime.config import model_cfg_bank
    cfg = copy.deepcopy(model_cfg_bank()("shgan_g1024"))
    a = cfg["args"]
    a["mapping"]["args"].update(z_dim=16, w_dim=16)
    a["encoder"]["args"].update(ch_base=2048, ch_max=16, oc_n=16,
                                shu_channels=4)
    a["synthesis"]["args"].update(ch_base=2048, ch_max=16, w_dim=16,
                                  w0_dim=16)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (2, 3, 1024, 1024), dtype=np.uint8)
    masks = (rng.rand(2, 1024, 1024) > 0.5).astype(np.float32)
    e = InpaintEngine(cfg, device=cuda, batch_size=2, seed=1)
    outs = {}
    for k3 in (True, False):
        if not k3:
            # a graph replays the route it was captured with: free it, and
            # capture again with the library conv in K3's place
            e.close()
            monkeypatch.setattr(conv_resample, "takes_k3",
                                lambda *a, **k: False)
        e.inpaint(imgs, masks)                       # captures
        torch.cuda.synchronize()
        build.reset_launches()
        outs[k3] = e.inpaint(imgs, masks)            # replays
        assert build.launches["conv3x3_lowch"] == (2 if k3 else 0)
    e.close()
    build.reset_launches()
    d = np.abs(outs[True].astype(int) - outs[False].astype(int))
    assert d.max() <= 1


def test_k3_route_follows_grad_mode_on_the_card(cuda):
    """An eligible conv (32 channels at 1024²) launches K3 in inference and
    the library conv where it records a gradient, which runs backward;
    both compute the same correlation."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 32, 1024, 1024), generator=g).to(cuda)
    w = (torch.randn((32, 32, 3, 3), generator=g) * 0.05).to(cuda)
    build.reset_launches()
    with torch.inference_mode():
        y_k3 = conv_resample._conv2d(x, w, padding=(1, 1))
    assert build.launches["conv3x3_lowch"] == 1
    xg = x.clone().requires_grad_()
    y = conv_resample._conv2d(xg, w, padding=(1, 1))
    assert build.launches["conv3x3_lowch"] == 1
    y.square().sum().backward()
    assert xg.grad is not None and xg.grad.shape == x.shape
    torch.testing.assert_close(y.detach(), y_k3, rtol=0, atol=1e-4)
    build.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,row0,window", [
    (4, 0, None), (64, 3, None), (512, 1000, None), (64, 2, (16, 24))])
def test_noise_bias_act_device_key_equals_scalar_key(cuda, dtype, res, row0,
                                                     window):
    """The epilogue keyed by a noise-table row on the card (its key_row
    operand) against the same key and row0 as scalars: bit for bit, whole
    planes and a window of plane rows; another table row draws other
    noise."""
    n, c = 3, 5
    h0, rows = window or (None, res)
    x, dcoefs, bias, const, strength = _nba_inputs(cuda, dtype, n, c, res,
                                                   seed=res + row0)
    x = x[:, :, :rows].contiguous()
    act = nba.epilogue_act(parse_activation(NBA_ACTS[1][0]), 0.7)
    layer = 2 * res + 1
    table = noise.noise_table(13, [2 * res, layer], row0).to(cuda)
    kw = dict(dcoefs=dcoefs, bias=bias, act=act, noise_mode="random",
              strength=strength, h0=h0)
    def bits(t):   # x holds a NaN: compare the bits
        return t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)

    want = nba.noise_bias_act(x.clone(), noise_key=noise.noise_key(13, layer),
                              row0=row0, **kw)
    got = nba.noise_bias_act(x.clone(), noise_key=table[layer], **kw)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(want))
    other = nba.noise_bias_act(x.clone(), noise_key=table[2 * res], **kw)
    assert not torch.equal(bits(other), bits(want))
    # the table row written anew reaches the launch that reads it
    table[layer, 2] = row0 + 1
    moved = nba.noise_bias_act(x.clone(), noise_key=table[layer], **kw)
    assert torch.equal(bits(moved), bits(nba.noise_bias_act(
        x.clone(), noise_key=noise.noise_key(13, layer), row0=row0 + 1,
        **kw)))


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
    assert build.launches[nba.kernel_of(kw["dcoefs"], mode)] == 1
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
    # channels-last is a layout the kernel takes; a transposed plane is not
    with pytest.raises(ValueError, match="contiguous"):
        nba.noise_bias_act(torch.zeros(1, 2, 4, 4, device=cuda).transpose(
            2, 3))
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
    nba.philox_normal_plain = (lambda k, b, r, device="cpu", row0=0, h0=0,
                               rows=None: noise.philox_normal_cuda(
                                   k, b, r, device, row0, h0, rows))
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


@pytest.mark.parametrize("res,m", [(16, 2), (64, 4), (128, 8)])
def test_noise_kernels_on_a_window_draw_the_planes_rows(cuda, res, m):
    """K1 alone, the fused epilogue and its grad kernel (both modes) on
    each rank's window of plane rows (spatial sharding): those rows of the
    whole-plane launch bit for bit, float32 and bf16."""
    key = noise.noise_key(6, 2 * res)
    whole = noise.philox_normal_cuda(key, 2, res, cuda, row0=3)
    gen = torch.Generator(device=cuda).manual_seed(8)
    act = nba.epilogue_act(parse_activation(
        "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, 8, res, res), generator=gen, device=cuda)
        dy = torch.randn((2, 8, res, res), generator=gen, device=cuda)
        x, dy = x.to(dtype), dy.to(dtype)
        kw = dict(dcoefs=torch.rand((2, 8), generator=gen, device=cuda),
                  bias=torch.randn((8,), generator=gen, device=cuda),
                  act=act, noise_mode="random", noise_key=key,
                  strength=torch.full((), 0.2, device=cuda), row0=3)
        y = nba.noise_bias_act_cuda(x, out=torch.empty_like(x), **kw)
        dx = nba.noise_bias_act_grad_cuda(dy, x, **kw)[0]
        mk = nba.noise_bias_act_mask_cuda(dy, x, **kw)
        r = res // m
        for h0 in range(0, res, r):
            rows = slice(h0, h0 + r)
            assert torch.equal(noise.philox_normal_cuda(
                key, 2, res, cuda, row0=3, h0=h0, rows=r), whole[:, rows])
            xs, dys = x[:, :, rows].contiguous(), dy[:, :, rows].contiguous()
            assert torch.equal(nba.noise_bias_act_cuda(
                xs, out=torch.empty_like(xs), h0=h0, **kw), y[:, :, rows])
            assert torch.equal(nba.noise_bias_act_grad_cuda(
                dys, xs, h0=h0, **kw)[0], dx[:, :, rows])
            assert torch.equal(nba.noise_bias_act_mask_cuda(
                dys, xs, h0=h0, **kw), mk[:, :, rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_on_a_halod_slab_is_the_planes_rows(cuda, dtype):
    """K3 on a slab with a row of halo above and below: those rows of the
    whole-plane launch, and its plain version's on the slab."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((1, 16, 128, 96), generator=gen, device=cuda).to(dtype)
    w = torch.randn((16, 16, 3, 3), generator=gen, device=cuda) / 12
    whole = conv1024.conv3x3_lowch(x, w)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
    for h0 in range(0, 128, 32):
        xs = xp[:, :, h0:h0 + 34].contiguous()
        got = conv1024.conv3x3_lowch(xs, w, halo=1)
        torch.testing.assert_close(got, whole[:, :, h0:h0 + 32], rtol=0,
                                   atol=1e-4)
        want = conv1024.conv3x3_lowch_plain(xs, w, halo=1).float()
        err = (got.float() - want).abs()
        if dtype == torch.bfloat16:   # one bf16 ulp of the plain version
            tol = 2.0 ** (torch.floor(torch.log2(
                want.abs().clamp_min(1e-30))) - 7) + 1e-6
        else:
            tol = torch.full_like(want, 1e-4)
        assert bool((err <= tol).all()), float(err.max())


# -- bias_lrelu: a conv layer's bias and activation in one launch ------------

def _conv_chain(x, bias, parsed, gain):
    """Conv2dLayer's bias and activation as PyTorch ops (``add_bias``, then
    ``lrelu_agc`` of the parsed spec, or the gain of a linear layer)."""
    from shgan_torch.ops.bias_act import add_bias, lrelu_agc
    if bias is not None:
        x = add_bias(x, bias)
    if parsed is not None:
        return lrelu_agc(x, **parsed[1], extra_gain=gain)
    return x * gain if gain != 1.0 else x


BL_ACTS = [
    # (spec, runtime gain, bias): the encoder's convs, D's conv1 (gain
    # sqrt(1/2)), a linear layer with a gain, no bias
    ("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)", 1.0, True),
    ("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)", float(np.sqrt(0.5)),
     True),
    (None, float(np.sqrt(0.5)), True),
    ("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)", 1.0, False),
]


def _bl_inputs(cuda, shape, seed, offset=0, dtype=torch.float32):
    """x with a NaN, ±0, ±inf and values past the clamp (``offset``
    elements off the 16-byte alignment), and a bias of its channels."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=g) * 150
    flat[offset:offset + 5] = torch.tensor([np.nan, -0.0, 0.0, np.inf,
                                            -np.inf])
    x = flat.to(cuda, dtype)[offset:].view(shape)
    bias = (torch.randn(shape[1], generator=g) * 0.3).to(cuda)
    return x, bias


def _same(a, b):
    """Equal bits up to the sign of a zero, NaN where NaN."""
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("act", range(len(BL_ACTS)))
@pytest.mark.parametrize("into", [False, True])
@pytest.mark.parametrize("shape,offset", [
    # the encoder's planes at batch 8: 32 x 1024², 64 x 512², 512 x 4²;
    # small planes, and 8 bytes off the 16-byte alignment (2-element path)
    ((8, 32, 1024, 1024), 0), ((8, 64, 512, 512), 0), ((8, 512, 4, 4), 0),
    ((3, 7, 6, 6), 0), ((2, 5, 8, 8), 2)])
def test_bias_lrelu_kernel_matches_the_chain_bit_for_bit(cuda, shape, offset,
                                                         into, act):
    """float32: one launch of the kernel, in place or into ``out``, gives
    the PyTorch chain's bits (up to the sign of a zero), NaN kept."""
    spec, gain, with_bias = BL_ACTS[act]
    x, bias = _bl_inputs(cuda, shape, seed=sum(shape) + act, offset=offset)
    bias = bias if with_bias else None
    want = _conv_chain(x.clone(), bias, parse_activation(spec), gain)
    a = nba.epilogue_act(parse_activation(spec), gain)
    build.reset_launches()
    if into:
        out = torch.empty_like(x)
        got = nba.noise_bias_act_cuda(x, None, bias, a, out=out)
        assert got.data_ptr() == out.data_ptr()
    else:
        got = nba.noise_bias_act(x, None, bias, a)
        assert got.data_ptr() == x.data_ptr()
    torch.cuda.synchronize()
    assert build.launches["bias_lrelu"] == 1
    assert build.launches["noise_bias_act"] == 0
    assert _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,h0,res", [
    ((2, 6, 16, 64), 24, 64),   # a slab of 16 rows of 64² planes
    ((2, 5, 3, 6), 1, 6)])      # 18 elements a plane: the 2-element path
def test_bias_lrelu_kernel_on_a_slab_window(cuda, dtype, shape, h0, res):
    """A window of plane rows (a spatial rank's slab, ``h0``): the chain's
    result on those rows (bf16: the float32 chain on the widened input,
    rounded once)."""
    x, bias = _bl_inputs(cuda, shape, seed=res + h0, dtype=dtype)
    spec, gain, _ = BL_ACTS[0]
    want = _conv_chain(x.float(), bias, parse_activation(spec),
                       gain).to(dtype)
    got = nba.noise_bias_act(x, None, bias,
                             nba.epilogue_act(parse_activation(spec), gain),
                             h0=h0)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.parametrize("act", range(len(BL_ACTS)))
@pytest.mark.parametrize("shape", [(8, 64, 512, 512), (8, 512, 4, 4),
                                   (2, 5, 6, 6)])
def test_bias_lrelu_kernel_bf16_is_one_rounding(cuda, shape, act):
    """bf16 I/O: the float32 chain on the widened input, rounded once to
    bf16, bit for bit (the chain in bf16 rounds after each op)."""
    spec, gain, with_bias = BL_ACTS[act]
    x, bias = _bl_inputs(cuda, shape, seed=act, dtype=torch.bfloat16)
    bias = bias if with_bias else None
    want = _conv_chain(x.float(), bias, parse_activation(spec),
                       gain).bfloat16()
    got = nba.noise_bias_act(x, None, bias,
                             nba.epilogue_act(parse_activation(spec), gain))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and _same(got.float(), want.float())


@pytest.mark.parametrize("model,convs,layers", [("shgan_g512", 16, 15),
                                                ("shgan_g1024", 18, 17)])
def test_replay_launches_bias_lrelu_at_each_encoder_conv(cuda, model, convs,
                                                         layers):
    """A replay of the compiled forward at full width launches the conv
    epilogue once for each of the encoder's Conv2dLayers and the fused
    synthesis epilogue once for each synthesis layer, and no chain."""
    res = 1024 if model == "shgan_g1024" else 512
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (1, 3, res, res), dtype=np.uint8)
    masks = (rng.rand(1, res, res) > 0.5).astype(np.float32)
    e = InpaintEngine(model, device=cuda, batch_size=1, seed=1)
    e.inpaint(imgs, masks)                          # captures
    torch.cuda.synchronize()
    build.reset_launches()
    e.inpaint(imgs, masks)                          # replays
    torch.cuda.synchronize()
    assert e.path() == "compiled"
    assert build.launches["bias_lrelu"] == convs
    assert build.launches["noise_bias_act"] == layers
    assert build.launches["noise_bias_act_grad"] == 0
    e.close()
    build.reset_launches()


def test_train_losses_through_the_conv_epilogue_match_the_chain(cuda,
                                                                monkeypatch):
    """shgan_ffhq256_train's G and D at full width, batch 2: Gmain's
    gradients (first order through G's encoder and D) and R1's (the second
    order through D) with every Conv2dLayer on the kernel and its grad
    kernel, against the same losses with the layers' PyTorch chain under
    autograd, leaf by leaf within 1e-4 of the leaf's norm."""
    from shgan_torch.models.layers import Conv2dLayer
    from shgan_torch.models.registry import get_model
    from shgan_torch.ops.conv_resample import conv2d_resample
    from shgan_torch.runtime.config import model_cfg_bank
    from shgan_torch.train import loss as TL
    bank = model_cfg_bank()
    G = get_model(bank("shgan_g256"), seed=0).to(cuda)
    D = get_model(bank("comodgan_d256"), seed=1).to(cuda)
    g = torch.Generator().manual_seed(3)
    real = (torch.rand(2, 3, 256, 256, generator=g) * 2 - 1).to(cuda)
    mask = (torch.rand(2, 1, 256, 256, generator=g) > 0.5).float().to(cuda)
    x_in = torch.cat([mask - 0.5, real * mask], dim=1)
    z = torch.randn(2, G.z_dim, generator=g).to(cuda)
    forward = Conv2dLayer.forward

    def chain(self, x, gain=1.0, slab=None, src=None):
        w = self.weight * self.weight_gain
        x = conv2d_resample(x, w.to(x.dtype), f=self.resample_filter,
                            up=self.up, down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1), slab=slab, src=src)
        return _conv_chain(x, self.bias, self.activation, gain)

    def grads(fused):
        monkeypatch.setattr(Conv2dLayer, "forward",
                            forward if fused else chain)
        out = []
        for m in (G, D):
            m.zero_grad(set_to_none=True)
        loss, _ = TL.g_main_loss(G, D, x_in, mask, z,
                                 torch.Generator().manual_seed(4))
        loss.backward()
        loss, _ = TL.d_r1_loss(D, mask, real)
        loss.backward()
        for m in (G, D):
            out += [(n, p.grad.clone()) for n, p in m.named_parameters()
                    if p.grad is not None]
        return out

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        build.reset_launches()
        got = grads(True)
        counts = dict(build.launches)
        want = grads(False)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert counts["bias_lrelu"] > 0 and counts["noise_bias_act_grad"] > 0
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        err = float((a - b).norm())
        assert err <= 1e-4 * float(b.norm()) + 1e-12, (name, err)


# ---- the channels-last (NHWC) maps -------------------------------------------


def _served(model, batch=8):
    """One forward of ``model`` at ``batch``: its K2 calls, its synthesis
    epilogues and its encoder conv epilogues as (channels, resolution)."""
    import chip_smoke as cs
    from shgan_torch.runtime.config import model_cfg_bank
    cfg = model_cfg_bank()(model)
    syn = cfg["args"]["synthesis"]["args"]
    ch = lambda r: min(int(syn["ch_base"]) // r, int(syn["ch_max"]))  # noqa
    return (cs.fir_calls(cfg, batch),
            [(ch(r), r) for r, k in cs.noise_layers(cfg).items()],
            [(c, r) for (r, c) in cs.encoder_conv_layers(cfg)])


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["shgan_g512", "shgan_g1024"])
def test_forward_kernels_nhwc_equal_nchw_at_the_served_shapes(cuda, model,
                                                               dtype):
    """Each forward kernel on a channels-last tensor (its NHWC map) gives
    the bits of its NCHW map at every served shape of ``model`` at batch 8:
    every K2 call, every synthesis epilogue (random noise keyed by a table
    row on the device), every encoder conv epilogue (bias_lrelu), K3 at
    1024²; each output in its input's layout, the NHWC launches counted
    beside the totals."""
    from shgan_torch.ops.layout import channels_last
    calls, syn, enc = _served(model)
    g = torch.Generator(device="cuda").manual_seed(3)
    act = nba.epilogue_act(parse_activation(
        "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"))
    row = torch.tensor([0x1234567, 0x89ABCDE, 5], dtype=torch.int64,
                       device=cuda)
    build.reset_launches()
    runs = 0

    def same(fn, shape):
        nonlocal runs
        x = (torch.randn(shape, generator=g, device=cuda) * 2).to(dtype)
        a = fn(x.clone())
        b = fn(x.contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
        assert a.is_contiguous() and channels_last(b), shape
        assert torch.equal(_bits(a), _bits(b)), shape
        runs += 1

    with torch.inference_mode():
        for site, r, shape, up, down, pads, gain in calls:
            t = fir_mod.correlation_taps(fir_mod.setup_filter([1, 3, 3, 1]),
                                         gain=gain)
            same(lambda x: fir_mod.fir(x, t, (up, up), (down, down), pads),
                 shape)
        for c, r in syn:
            d = torch.rand(8, c, generator=g, device=cuda) + 0.5
            b = torch.randn(c, generator=g, device=cuda) * 0.1
            s = torch.full((), 0.3, device=cuda)
            same(lambda x: nba.noise_bias_act(
                x, d, b, act, noise_mode="random", noise_key=row,
                strength=s), (8, c, r, r))
        for c, r in enc:
            b = torch.randn(c, generator=g, device=cuda) * 0.1
            same(lambda x: nba.noise_bias_act(x, None, b, act), (8, c, r, r))
        if model == "shgan_g1024":
            w = torch.randn(32, 32, 3, 3, generator=g, device=cuda) / 17
            same(lambda x: conv1024.conv3x3_lowch(x, w), (8, 32, 1024, 1024))
    total, nhwc = build.snapshot(), build.snapshot_nhwc()
    assert sum(total[k] for k in build.FORWARD_KERNELS) == 2 * runs
    assert {k: 2 * v for k, v in nhwc.items()} == {
        k: total[k] for k in build.FORWARD_KERNELS}
    assert build.nhwc_share(total, nhwc) == 0.5
    build.reset_launches()


@pytest.mark.parametrize("model", ["shgan_g512", "shgan_g1024"])
def test_modulated_weights_reach_cudnn_channels_last(cuda, model,
                                                     monkeypatch, capsys):
    """Every synthesis layer's modulated conv on a channels-last input at
    full width: its normalized weight reaches F.conv2d / F.conv_transpose2d
    already channels-last (no copy by cuDNN), the conv gives the values of
    the NCHW weight's conv in the same layout, and its dcoefs, summed from
    the same values in NCHW order, are the NCHW weight's bit for bit."""
    import torch.nn.functional as F
    from shgan_torch.models import get_model
    from shgan_torch.ops import modulated_conv
    from shgan_torch.runtime.config import model_cfg_bank
    torch.backends.cudnn.allow_tf32 = True      # as served
    G = get_model(model_cfg_bank()(model), seed=0).to(cuda).eval()
    g = torch.Generator(device="cuda").manual_seed(5)
    layers = differ = 0
    for m in G.modules():
        if not isinstance(m, SynthesisLayer):
            continue
        o, i = m.weight.shape[:2]
        x = torch.randn(8, i, 16, 16, generator=g, device=cuda)
        s = torch.randn(8, i, generator=g, device=cuda)
        kw = dict(up=m.up, padding=m.padding,
                  resample_filter=m.resample_filter, flip_weight=m.up == 1,
                  split_dcoefs=True)
        xl = x.contiguous(memory_format=torch.channels_last)
        seen = []
        with monkeypatch.context() as mp:
            for name in ("conv2d", "conv_transpose2d"):
                f = getattr(F, name)
                mp.setattr(F, name, lambda a, w, *r, _f=f, **k: (
                    seen.append(w.is_contiguous(
                        memory_format=torch.channels_last)), _f(a, w, *r,
                                                                **k))[1])
            with torch.inference_mode():
                got, d_cl = modulated_conv.modulated_conv2d(
                    xl, m.weight, s, **kw)
        with torch.inference_mode():
            _, d_nchw = modulated_conv.modulated_conv2d(x, m.weight, s, **kw)
            # the same conv with the NCHW normalized weight, as before
            wn = m.weight * torch.rsqrt(
                m.weight.square().mean(dim=(1, 2, 3), keepdim=True))
            sn = s * torch.rsqrt(s.square().mean())
            want = conv_resample.conv2d_resample(
                xl * sn[:, :, None, None], wn, f=m.resample_filter, up=m.up,
                padding=m.padding, flip_weight=m.up == 1)
        torch.cuda.synchronize()
        assert seen == [True], (m.up, seen)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(d_cl, d_nchw)
        layers += 1
    with capsys.disabled():
        print(f"\n{model}: {layers} modulated convs, weights channels-last, "
              f"dcoefs bit for bit")
    assert layers > 0


def test_backward_wrappers_refuse_channels_last_on_the_card(cuda):
    """K2 and the epilogue under autograd take NCHW only: a channels-last
    tensor that records a gradient raises, and so does the grad kernel's
    own entry on a channels-last operand."""
    cl = torch.channels_last
    x = torch.randn(2, 8, 16, 16, device=cuda).contiguous(memory_format=cl)
    act = nba.epilogue_act(parse_activation(NBA_ACTS[1][0]), 1.0)
    with pytest.raises(ValueError, match="NCHW"):
        fir_mod.upfirdn2d(x.clone().requires_grad_(),
                          fir_mod.setup_filter([1, 3, 3, 1]), padding=1)
    with pytest.raises(ValueError, match="NCHW"):
        nba.noise_bias_act(x.clone().requires_grad_(), None,
                           torch.zeros(8, device=cuda), act)
    with pytest.raises(ValueError, match="NCHW"):
        nba.noise_bias_act(x.clone(), None,
                           torch.zeros(8, device=cuda, requires_grad=True),
                           act)
    with pytest.raises(ValueError, match="contiguous"):
        nba.noise_bias_act_grad_cuda(x, x, act=act)
    with torch.no_grad():   # no gradient: the NHWC maps run
        fir_mod.upfirdn2d(x, fir_mod.setup_filter([1, 3, 3, 1]), padding=1)
        nba.noise_bias_act(x.clone(), act=act)


@pytest.mark.parametrize("model,limits", [("shgan_g512", (2.5, 0.8)),
                                          ("shgan_g1024", (4.5, 0.9))])
def test_compiled_forward_runs_channels_last(cuda, model, limits, capsys):
    """A full-width replay at batch 8, TF32 on as served: every hand-written
    forward launch takes the NHWC map, the profiler sees no cuDNN layout
    transpose (nchwToNhwc / nhwcToNchw) of an activation in it, and its
    composites keep the known pixels and stay within the serving cell's
    limits of the NCHW eager forward (equal where cuDNN picks the same
    algorithms); the figures are printed.  One transpose kernel remains:
    cuDNN's conversion of the 4-channel fromrgb conv's weight [C, 4, 1, 1]
    for its TF32 algorithm, ~2 µs, which a channels-last weight runs
    alike; it is held to one launch of a few µs."""
    from torch.profiler import ProfilerActivity, profile
    from shgan_torch.data.rng import derive_seed
    from shgan_torch.models.infer import composite_forward, z_for_positions
    from shgan_torch.serve import BATCH_NOISE_SALT
    torch.backends.cudnn.allow_tf32 = True      # as served
    res = 1024 if model == "shgan_g1024" else 512
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (8, 3, res, res), dtype=np.uint8)
    masks = (rng.rand(8, res, res) > 0.5).astype(np.float32)
    e = InpaintEngine(model, device=cuda, batch_size=8, seed=1)
    with torch.no_grad():
        for name, p in e.G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    e.inpaint(imgs, masks)                              # captures
    torch.cuda.synchronize()
    build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = e.inpaint(imgs, masks, start_index=16)    # replays
        torch.cuda.synchronize()
    assert e.path() == "compiled"
    total, nhwc = build.snapshot(), build.snapshot_nhwc()
    names = [k.key for k in prof.key_averages()]
    transposes = [(k.key, k.count, k.device_time_total)
                  for k in prof.key_averages()
                  if "nchwtonhwc" in k.key.lower()
                  or "nhwctonchw" in k.key.lower()]
    assert any("upfirdn2d" in n for n in names), names[:20]
    assert len(transposes) <= 1 and all(
        c == 1 and us < 10.0 for _, c, us in transposes), transposes
    assert build.nhwc_share(total, nhwc) == 1.0
    z = z_for_positions(1, e.G.z_dim, range(16, 24))
    with torch.inference_mode():
        want = composite_forward(
            e.G, torch.from_numpy(imgs).to(cuda),
            torch.from_numpy(masks[:, None]).to(cuda),
            torch.from_numpy(z).to(cuda),
            noise_seed=derive_seed(1, 16, BATCH_NOISE_SALT)).cpu().numpy()
    e.close()
    build.reset_launches()
    kept = np.broadcast_to(masks[:, None] > 0.5, got.shape)
    gap = got.astype(np.float64) - want.astype(np.float64)
    assert np.array_equal(got[kept], want[kept])
    off = 100.0 * float((np.abs(gap[~kept]) > 1).mean())
    rms = float(np.sqrt((gap[~kept] ** 2).mean()))
    with capsys.disabled():
        print(f"\n{model} b8 channels-last replay vs NCHW eager: "
              f"{int((gap != 0).sum())} of {gap.size} values differ, "
              f"{off:.4f} % of hole values by > 1 level, RMS {rms:.4f}, "
              f"max {int(np.abs(gap).max())}; launches {total}, NHWC {nhwc}")
    assert off <= limits[0] and rms <= limits[1]


# ---- the fold: the epilogue writes its consumers' inputs ------------------

FOLDS = [(True, 1), (False, 1), (False, 2)]   # the synthesis runs these


@pytest.mark.parametrize("nhwc", [False, True])
@pytest.mark.parametrize("add,outs", FOLDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,c,mode", [(4, 512, "random"), (8, 7, "const"),
                                        (64, 64, "random"), (512, 4, "none")])
def test_noise_bias_act_fold_is_the_chain_bit_for_bit(cuda, res, c, mode,
                                                      dtype, add, outs,
                                                      nhwc):
    """The fold on both maps: one launch whose outputs are the plain
    epilogue's launch followed by the chain it replaces (``+ addend``, then
    ``* scale.to(x.dtype)`` for each consumer) bit for bit, NaN where the
    chain has NaN; output 1 in x's buffer, every output in x's layout."""
    from shgan_torch.ops.layout import channels_last
    x, dcoefs, bias, const, strength = _nba_inputs(
        cuda, dtype, 2, c, res, seed=res + c, offset=2 if res == 8 else 0)
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    x = x.contiguous(memory_format=fmt) if nhwc else x
    g = torch.Generator(device="cuda").manual_seed(c)
    x0 = (torch.randn(x.shape, generator=g, device=cuda) * 20).to(
        dtype).contiguous(memory_format=fmt)
    scales = tuple(torch.randn(2, c, generator=g, device=cuda) + 1.0
                   for _ in range(outs))
    spec, gain = NBA_ACTS[(res + c) % 3]
    kw = dict(dcoefs=dcoefs, bias=bias,
              act=nba.epilogue_act(parse_activation(spec), gain),
              noise_mode=mode, noise_key=noise.noise_key(5, 2 * res),
              noise_const=const, strength=strength)
    ref = nba.noise_bias_act(x.clone(), **kw)
    if add:
        ref = ref + x0
    refs = [ref * s.to(dtype)[:, :, None, None] for s in scales] or [ref]
    xin = x   # res 8: 2 elements off the 16-byte alignment (NCHW)
    build.reset_launches()
    got = nba.noise_bias_act(xin, addend=x0 if add else None, scales=scales,
                             **kw)
    torch.cuda.synchronize()
    assert build.launches["noise_bias_act"] == 1
    assert build.launches_nhwc["noise_bias_act"] == int(nhwc)
    got = list(got) if outs else [got]
    assert len(got) == len(refs) and got[0].data_ptr() == xin.data_ptr()
    for a, b in zip(got, refs):
        assert a.dtype == dtype and channels_last(a) == nhwc
        a, b = a.float(), b.float()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(b)
        assert torch.equal(a[ok], b[ok]), float((a[ok] - b[ok]).abs().max())
    build.reset_launches()


def test_shgan_g512_synthesis_route_is_the_grad_path_bit_for_bit(cuda,
                                                                 capsys):
    """The full-width ``shgan_g512`` synthesis at batch 2, TF32 off and
    cuDNN deterministic, random noise: the forward under ``no_grad`` (the
    fold's route: 22 prescaled modulated convs, 1 that multiplies) against
    the same forward recording a gradient (none prescaled), bit for bit."""
    from shgan_torch.models import get_model
    from shgan_torch.runtime.config import model_cfg_bank
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        G = get_model(model_cfg_bank()("shgan_g512"), seed=0).to(cuda)
        syn = G.synthesis
        with torch.no_grad():
            for name, p in syn.named_parameters():
                if name.endswith("noise_strength"):
                    p.fill_(0.1)
        g = torch.Generator(device="cuda").manual_seed(1)
        n = 2
        x = torch.randn(n, syn.b4.fc.weight.shape[1], generator=g,
                        device=cuda)
        feats = {r: torch.randn(n, (syn.b4.conv if r == 4 else getattr(
            syn, f"b{r}").conv1).weight.shape[0], r, r, generator=g,
            device=cuda) for r in syn.block_res}
        w_dim = syn.b4.conv.affine.weight.shape[1] - x.shape[1]
        ws = torch.randn(n, syn.num_ws, w_dim, generator=g, device=cuda)
        counts = []
        outs = []
        for grad in (False, True):
            build.reset_launches()
            with torch.set_grad_enabled(grad):
                outs.append(syn(x, feats, ws, noise_mode="random",
                                noise_seed=7).detach())
            torch.cuda.synchronize()
            counts.append(build.snapshot_modconv())
    finally:
        torch.backends.cudnn.deterministic = prev
        build.reset_launches()
    with capsys.disabled():
        print(f"\nshgan_g512 synthesis b2: route {counts[0]}, grad path "
              f"{counts[1]}, max |diff| "
              f"{float((outs[0] - outs[1]).abs().max())}")
    assert counts == [{"prescaled": 22, "multiplied": 1},
                      {"prescaled": 0, "multiplied": 23}]
    assert torch.equal(outs[0], outs[1])
