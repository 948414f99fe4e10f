"""Kernels K1, K2 and K3 against their plain PyTorch versions on the card.

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
from shgan_torch.ops import conv1024, noise
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,down,pads,gain", FIR_CASES)
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
@pytest.mark.parametrize("shape,taps,pads,offset", [
    ((2, 3, 21, 37), (3, 5), (-1, 2, 2, 0), 0),
    ((2, 9, 13, 13), (8, 8), (3, 4, 4, 3), 0),
    ((1, 2, 70, 67), (8, 8), (1, 2, 3, 0), 0),
    ((2, 5, 17, 19), (4, 4), (1, 1, 1, 1), 1),   # 4 bytes off 16: generic
    ((2, 4, 40, 70), (4, 4), (2, 1, 1, 2), 0),   # 4x4, random taps
])
def test_upfirdn2d_kernel_other_taps(cuda, dtype, shape, taps, pads, offset):
    """The tiled path with taps other than the main path's, and a tensor
    that starts off the 16-byte alignment its loads need (the generic
    kernel takes it)."""
    g = torch.Generator().manual_seed(2)
    t = torch.randn(taps, generator=g).numpy()
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=g).to(cuda, dtype)
    x = flat[offset:].view(shape)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    got = fir_mod.fir_cuda(x, t, (1, 1), (1, 1), pads)
    want = fir_mod.fir_plain(x.float(), t, (1, 1), (1, 1), pads)
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
    build.reset_launches()
    x = torch.randn(1, 2, 8, 8, device=cuda)
    fir_mod.upfirdn2d(x, fir_mod.setup_filter([1, 3, 3, 1]), padding=1)
    noise.random_noise(0, 8, 2, 8, cuda)
    assert build.launches == {"upfirdn2d": 1, "philox_normal": 1,
                              "conv3x3_lowch": 0}
    with pytest.raises(RuntimeError):
        fir_mod.upfirdn2d(x.requires_grad_(), fir_mod.setup_filter([1, 3]))


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
