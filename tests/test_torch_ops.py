"""shgan_torch plain-torch ops against shgan_tpu on the same numpy inputs:
conv2d_resample, modulated_conv2d, lrelu_agc / get_activation, dense."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shgan_tpu.ops import bias_act as jba
from shgan_tpu.ops import conv2d_resample as j_conv2d_resample
from shgan_tpu.ops import setup_filter
from shgan_tpu.ops.dense import dense_apply as j_dense
from shgan_tpu.ops.modulated_conv import modulated_conv2d as j_modconv
from shgan_torch.ops import bias_act as tba
from shgan_torch.ops.conv_resample import conv2d_resample
from shgan_torch.ops.dense import dense_apply
from shgan_torch.ops.modulated_conv import modulated_conv2d

T = torch.from_numpy
ACT = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"

RESAMPLE_CASES = [
    dict(k=3, up=2, down=1, groups=1, flip_weight=False),   # synthesis up
    dict(k=3, up=2, down=1, groups=1, flip_weight=True),
    dict(k=3, up=1, down=2, groups=1, flip_weight=True),    # encoder down
    dict(k=1, up=1, down=2, groups=1, flip_weight=True),    # 1x1 down
    dict(k=1, up=2, down=1, groups=1, flip_weight=True),    # 1x1 up
    dict(k=3, up=1, down=1, groups=1, flip_weight=True, padding=1),  # plain
    dict(k=3, up=1, down=1, groups=1, flip_weight=False,
         padding=[0, 1, 1, 0]),                              # signed pad
    dict(k=3, up=2, down=2, groups=1, flip_weight=False),   # up then down
    dict(k=3, up=2, down=1, groups=2, flip_weight=False),   # grouped up
    dict(k=3, up=1, down=2, groups=2, flip_weight=True),    # grouped down
]


@pytest.mark.parametrize("case", RESAMPLE_CASES)
def test_conv2d_resample_matches_jax(case):
    case = dict(case)
    k = case.pop("k")
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    w = rng.randn(6, 4 // case["groups"], k, k).astype(np.float32)
    f = setup_filter([1, 3, 3, 1])
    case.setdefault("padding", k // 2)
    want = np.asarray(j_conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f,
                                        **case))
    got = conv2d_resample(T(x), T(w), f=f, **case).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("demodulate,use_noise,up", [
    (True, False, 1), (True, True, 1), (True, True, 2), (False, False, 1),
    (False, True, 1),
])
def test_modulated_conv2d_matches_jax(demodulate, use_noise, up):
    rng = np.random.RandomState(6)
    x = rng.randn(3, 5, 8, 8).astype(np.float32)
    k = 1 if not demodulate else 3
    w = rng.randn(4, 5, k, k).astype(np.float32)
    s = rng.randn(3, 5).astype(np.float32)
    res = 8 * up
    noise = (rng.randn(3, 1, res, res).astype(np.float32) * 0.5
             if use_noise else None)
    f = setup_filter([1, 3, 3, 1]) if up > 1 else None
    kw = dict(up=up, padding=k // 2, resample_filter=f,
              demodulate=demodulate, flip_weight=(up == 1))
    want = np.asarray(j_modconv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        noise=None if noise is None else jnp.asarray(noise), **kw))
    got = modulated_conv2d(T(x), T(w), T(s),
                           noise=None if noise is None else T(noise),
                           **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("spec", [
    ACT, "lrelu_agc(alpha=0.2, gain=sqrt_2)", "relu", "sine(freq=3.0)",
])
@pytest.mark.parametrize("gain", [1.0, float(np.sqrt(0.5))])
def test_activations_match_jax(spec, gain):
    x = (np.random.RandomState(7).randn(4, 64) * 300).astype(np.float32)
    want = np.asarray(jba.get_activation(spec)(jnp.asarray(x), gain=gain))
    got = tba.get_activation(spec)(T(x), gain=gain).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert tba.get_activation("none") is None
    assert tba.get_activation(None) is None


def test_lrelu_agc_and_fma():
    x = (np.random.RandomState(8).randn(100) * 10).astype(np.float32)
    want = np.asarray(jba.lrelu_agc(jnp.asarray(x), alpha=0.2, gain=2.0,
                                    clamp=5.0, extra_gain=0.5))
    got = tba.lrelu_agc(T(x), alpha=0.2, gain=2.0, clamp=5.0,
                        extra_gain=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    a, b, c = (T(np.random.RandomState(i).randn(3, 4).astype(np.float32))
               for i in range(3))
    torch.testing.assert_close(tba.fma(a, b, c), a * b + c)
    with pytest.raises(ValueError):
        tba.get_activation("nope(x=1)")


@pytest.mark.parametrize("lr_multi,act,bias", [
    (1.0, None, True), (0.01, ACT, True), (1.0, ACT, False),
])
def test_dense_matches_jax(lr_multi, act, bias):
    rng = np.random.RandomState(9)
    w = rng.randn(16, 24).astype(np.float32) / lr_multi
    b = rng.randn(16).astype(np.float32) if bias else None
    x = rng.randn(5, 24).astype(np.float32)
    params = {"weight": jnp.asarray(w)}
    if bias:
        params["bias"] = jnp.asarray(b)
    want = np.asarray(j_dense(params, jnp.asarray(x), lr_multi=lr_multi,
                              activation=act))
    got = dense_apply(T(w), None if b is None else T(b), T(x),
                      lr_multi=lr_multi, activation=act).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
