"""Kernel K3's module (shgan_torch/ops/conv1024.py) against shgan_tpu: the
plain version against the Pallas kernel in interpret mode, the routing of
conv2d_resample against the JAX package's with its switch on, and the
port's route following the conv's grad mode, on the CPU."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import shgan_tpu.ops.conv1024 as j24
import shgan_tpu.ops.conv_resample as jcr
from shgan_torch.kernels import build
from shgan_torch.ops import conv1024 as t24
from shgan_torch.ops import conv_resample
from shgan_torch.ops.conv_resample import conv2d_resample


@pytest.mark.parametrize("n,c,h,w", [(2, 8, 16, 256), (1, 32, 24, 128)])
def test_plain_matches_pallas_interpret(n, c, h, w, monkeypatch):
    """The shapes of tests/test_conv1024.py, run the way it runs them."""
    monkeypatch.setattr(j24, "BH", 8)
    rng = np.random.RandomState(0)
    x = rng.randn(n, c, h, w).astype(np.float32)
    wt = (rng.randn(c, c, 3, 3) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(
            lambda a, b: j24.conv3x3_lowch.__wrapped__(a, b))(
                jnp.asarray(x), jnp.asarray(wt)))
    got = t24.conv3x3_lowch_plain(torch.from_numpy(x),
                                  torch.from_numpy(wt)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_plain_rounds_weights_and_output_to_bf16():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 4, 9, 9).astype(np.float32))
    wt = torch.from_numpy((rng.randn(3, 4, 3, 3) * 0.3).astype(np.float32))
    xb = x.bfloat16()
    got = t24.conv3x3_lowch_plain(xb, wt)
    assert got.dtype == torch.bfloat16
    want = torch.nn.functional.conv2d(xb.float(), wt.bfloat16().float(),
                                      padding=1).bfloat16()
    assert (got.float() - want.float()).abs().max() <= 2 ** -6


@pytest.mark.parametrize("flip_weight", [True, False])
def test_routing_matches_jax(flip_weight, monkeypatch):
    """With MIN_RES lowered to 16 in both packages and the JAX package's
    switch on, an eligible conv2d_resample call goes to conv3x3_lowch (the
    plain version on a CPU tensor, no kernel launch) and equals the JAX
    package's."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 8, 16, 16).astype(np.float32)
    wt = (rng.randn(8, 8, 3, 3) * 0.1).astype(np.float32)
    for mod in (j24, t24):
        monkeypatch.setattr(mod, "MIN_RES", 16)
    monkeypatch.setattr(j24, "_IMPL", "pallas")
    calls = []
    plain = t24.conv3x3_lowch_plain
    monkeypatch.setattr(t24, "conv3x3_lowch_plain",
                        lambda a, b, halo=0: calls.append(a.shape)
                        or plain(a, b, halo))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jcr.conv2d_resample(
            jnp.asarray(x), jnp.asarray(wt), padding=1,
            flip_weight=flip_weight))
    build.reset_launches()
    got = conv2d_resample(torch.from_numpy(x), torch.from_numpy(wt),
                          padding=1, flip_weight=flip_weight).numpy()
    assert calls == [(1, 8, 16, 16)]
    assert build.launches["conv3x3_lowch"] == 0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    # the library conv agrees: the weight reaching K3 is the flipped one
    lib = torch.nn.functional.conv2d(
        torch.from_numpy(x),
        torch.from_numpy(wt if flip_weight else wt[:, :, ::-1, ::-1].copy()),
        padding=1).numpy()
    np.testing.assert_allclose(got, lib, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("x_shape,w_shape,stride,groups,padding", [
    ((1, 8, 16, 16), (8, 8, 3, 3), 1, 1, (1, 1)),      # eligible
    ((1, 8, 16, 16), (8, 8, 3, 3), 2, 1, (1, 1)),      # stride 2
    ((1, 64, 16, 16), (64, 64, 3, 3), 1, 1, (1, 1)),   # 64 channels
    ((1, 8, 16, 16), (8, 8, 1, 1), 1, 1, (0, 0)),      # 1×1
    ((1, 8, 16, 16), (8, 4, 3, 3), 1, 2, (1, 1)),      # grouped
    ((1, 8, 16, 8), (8, 8, 3, 3), 1, 1, (1, 1)),       # not square
    ((1, 8, 12, 12), (8, 8, 3, 3), 1, 1, (1, 1)),      # below MIN_RES
])
def test_eligibility_matches_jax(x_shape, w_shape, stride, groups, padding,
                                 monkeypatch):
    for mod in (j24, t24):
        monkeypatch.setattr(mod, "MIN_RES", 16)
    monkeypatch.setattr(j24, "_IMPL", "pallas")
    want = j24.conv1024_eligible(x_shape, w_shape, stride, groups, padding)
    assert t24.conv1024_eligible(x_shape, w_shape, stride, groups,
                                 padding) == want
    assert want == (x_shape == (1, 8, 16, 16) and stride == 1
                    and groups == 1 and w_shape == (8, 8, 3, 3))


@pytest.mark.parametrize("case,k3", [
    ("inference", True),          # nothing records a gradient
    ("x_grad", False),            # x.requires_grad under grad mode
    ("w_grad", False),            # w.requires_grad under grad mode
    ("no_grad", True),            # requires_grad tensors under no_grad
    ("inference_mode", True),     # requires_grad tensors, inference mode
])
def test_route_follows_the_input(case, k3, monkeypatch):
    """An eligible conv (32 channels at 1024²) runs K3's plain version on
    the CPU unless it records a gradient, and the library conv where it
    does; no switch is set.  Both compute the same correlation."""
    calls = []
    plain = t24.conv3x3_lowch_plain
    monkeypatch.setattr(t24, "conv3x3_lowch_plain",
                        lambda a, b, halo=0: calls.append(a.shape)
                        or plain(a, b, halo))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 32, 1024, 1024), generator=g)
    w = torch.randn((32, 32, 3, 3), generator=g) * 0.05
    x.requires_grad_(case in ("x_grad", "no_grad", "inference_mode"))
    w.requires_grad_(case in ("w_grad", "no_grad", "inference_mode"))
    mode = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode
            }.get(case, torch.enable_grad)
    with mode():
        y = conv_resample._conv2d(x, w, padding=(1, 1))
    assert calls == ([(1, 32, 1024, 1024)] if k3 else [])
    assert y.requires_grad == (not k3)
    with torch.no_grad():
        want = torch.nn.functional.conv2d(x, w, padding=1)
    torch.testing.assert_close(y.detach(), want, atol=1e-4, rtol=1e-4)


def test_wrapper_checks_and_cpu_route():
    x = torch.randn(1, 4, 8, 8)
    w = torch.randn(4, 4, 3, 3)
    build.reset_launches()
    torch.testing.assert_close(t24.conv3x3_lowch(x, w),
                               t24.conv3x3_lowch_plain(x, w))
    assert build.launches["conv3x3_lowch"] == 0
    with pytest.raises(ValueError):
        t24.conv3x3_lowch(torch.randn(1, 40, 8, 8), torch.randn(4, 40, 3, 3))
    with pytest.raises(ValueError):
        t24.conv3x3_lowch(x, torch.randn(4, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        t24.conv3x3_lowch_cuda(x, w)
