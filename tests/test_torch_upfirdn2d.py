"""shgan_torch upfirdn2d (the module of kernel K2) against shgan_tpu.

The same numpy inputs go through the JAX function and its port.  On the
CPU the port runs the kernel's plain version; the kernel itself is held to
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from shgan_tpu.ops import fir_pallas

# the packages export a function of the module's name: import the modules
jup = importlib.import_module("shgan_tpu.ops.upfirdn2d")
tup = importlib.import_module("shgan_torch.ops.upfirdn2d")

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


@pytest.mark.parametrize("case", CASES)
def test_upfirdn2d_matches_jax(case):
    x = np.random.RandomState(0).randn(2, 3, 8, 9).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1])
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), f, **case))
    got = tup.upfirdn2d(torch.from_numpy(x), tup.setup_filter([1, 3, 3, 1]),
                        **case).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_upfirdn2d_identity_and_separable():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 12, 12).astype(np.float32)
    got = tup.upfirdn2d(torch.from_numpy(x), None).numpy()
    np.testing.assert_array_equal(got, x)
    f1 = tup.setup_filter([1, 2, 4, 6, 6, 4, 2, 1])  # 8 taps → 1D
    assert f1.ndim == 1
    np.testing.assert_array_equal(f1, jup.setup_filter([1, 2, 4, 6, 6, 4, 2, 1]))
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), f1, up=2, padding=2))
    got = tup.upfirdn2d(torch.from_numpy(x), f1, up=2, padding=2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["filter2d", "upsample2d", "downsample2d"])
def test_wrappers_match_jax(name):
    x = np.random.RandomState(4).randn(2, 3, 8, 8).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1])
    want = np.asarray(getattr(jup, name)(jnp.asarray(x), f))
    got = getattr(tup, name)(torch.from_numpy(x), f).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture
def interpret_impl():
    prev = fir_pallas.get_fir_impl()
    fir_pallas.set_fir_impl("interpret")
    yield
    fir_pallas.set_fir_impl(prev)


# the shapes of tests/test_fir_pallas.py::test_interpret_matches_xla
@pytest.mark.parametrize("shape,taps", [
    ((2, 3, 19, 23), (4, 4)),
    ((1, 5, 12, 33), (3, 5)),
    ((2, 4, 9, 9), (1, 2)),
])
def test_plain_fir_matches_pallas_interpret(interpret_impl, shape, taps):
    """up=down=1, pad 0, separable taps: the plain FIR equals the TPU
    kernel's valid separable correlation, run in the Pallas interpreter."""
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    fcol = tuple(float(v) for v in rng.randn(taps[0]))
    frow = tuple(float(v) for v in rng.randn(taps[1]))
    want = np.asarray(fir_pallas.fir_separable_valid(jnp.asarray(x), fcol,
                                                     frow))
    got = tup.fir_plain(torch.from_numpy(x),
                        np.outer(fcol, frow).astype(np.float32)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_plain_fir_bf16_sums_in_float32():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(1, 2, 10, 10).astype(np.float32))
    taps = tup.correlation_taps(tup.setup_filter([1, 3, 3, 1]), gain=4)
    ref = tup.fir_plain(x.bfloat16().float(), taps, pads=(1, 1, 1, 1))
    got = tup.fir_plain(x.bfloat16(), taps, pads=(1, 1, 1, 1))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.bfloat16())


def test_out_size_matches_contract():
    for n, up, down, p0, p1, t in [(8, 2, 1, 2, 1, 4), (9, 1, 2, 1, 1, 4),
                                   (5, 2, 2, -1, 3, 3), (64, 1, 1, 1, 1, 4)]:
        y = tup.fir_plain(torch.zeros(1, 1, n, n),
                          np.ones((t, t), np.float32), (up, up),
                          (down, down), (p0, p1, p0, p1))
        assert y.shape[-1] == tup.out_size(n, up, down, p0, p1, t)


def test_cuda_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError):
        tup.fir_cuda(torch.zeros(1, 1, 4, 4), np.ones((1, 1), np.float32))
