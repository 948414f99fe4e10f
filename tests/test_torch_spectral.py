"""shgan_torch spectral ops and the SHU against shgan_tpu / numpy."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import params_to_flat_state_dict
from shgan_tpu.models import SHU as JSHU
from shgan_tpu.spectral import dft as jdft
from shgan_tpu.spectral import shu_ops as jops
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.models import SHU
from shgan_torch.spectral import dft, shu_ops

T = torch.from_numpy


def test_rfft2_matches_numpy():
    x = np.random.RandomState(0).randn(2, 3, 16, 16).astype(np.float32)
    re, im = dft.rfft2(T(x))
    want = np.fft.rfft2(x.astype(np.float64), norm="forward")
    np.testing.assert_allclose(re.numpy(), want.real, atol=1e-6)
    np.testing.assert_allclose(im.numpy(), want.imag, atol=1e-6)


@pytest.mark.parametrize("s", [(8, 8), (4, 4), (16, 16)])
def test_irfft2_matches_jax_on_non_hermitian_input(s):
    """The SHU's cropped half-spectra are not Hermitian; the port defines
    irfft2 there as the JAX package (and np.fft.irfft2) does."""
    rng = np.random.RandomState(1)
    shape = (2, 3, s[0], s[1] // 2 + 1)
    re = rng.randn(*shape).astype(np.float32)
    im = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jdft.irfft2_matmul(jnp.asarray(re), jnp.asarray(im), s))
    got = dft.irfft2(T(re), T(im), s).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        got, np.fft.irfft2(re + 1j * im, s=s, norm="forward"), atol=1e-5)


def test_shift_unshift_and_filter_match_jax():
    rng = np.random.RandomState(2)
    ff = rng.randn(2, 4, 16, 9).astype(np.float32)
    np.testing.assert_array_equal(shu_ops.spectral_shift(T(ff)).numpy(),
                                  np.asarray(jops.spectral_shift(ff)))
    np.testing.assert_array_equal(shu_ops.spectral_unshift(T(ff), 8).numpy(),
                                  np.asarray(jops.spectral_unshift(ff, 8)))
    w = rng.randn(4, 6 * 6).astype(np.float32)
    cw = rng.rand(6, 16, 9).astype(np.float32)
    want = np.asarray(jops.heterogeneous_filter_apply(jnp.asarray(w),
                                                      jnp.asarray(ff), cw, 6))
    got = shu_ops.heterogeneous_filter_apply(T(w), T(ff), T(cw), 6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_shu_matches_jax():
    kw = dict(dfilter_freedom=(2, 3), dfilter_type="piecewise_linear",
              input_res=16, lowest_res=4, tail_sigma_mult=3)
    js = JSHU(4, 4, **kw)
    params = js.init(jax.random.key(3))
    ts = SHU(4, 4, **kw)
    ts.load_state_dict(params_from_jax(params), strict=True)
    assert set(ts.state_dict()) == set(params_to_flat_state_dict(params))
    x = np.random.RandomState(1).randn(2, 4, 16, 16).astype(np.float32)
    want = js(params, jnp.asarray(x))
    with torch.no_grad():
        got = ts(T(x))
    assert sorted(got) == sorted(want) == [4, 8, 16]
    for res in want:
        assert got[res].shape == (2, 4, res, res)
        np.testing.assert_allclose(got[res].numpy(), np.asarray(want[res]),
                                   atol=1e-4)
