"""rfft2 / irfft2 with ``norm='forward'`` through ``torch.fft`` (port of
``shgan_tpu/spectral/dft.py``, which computed the same functions as
matmul-DFTs for the TPU).

The SHU hands :func:`irfft2` cropped, windowed half-spectra that are not
Hermitian.  Its result is defined the way ``np.fft.irfft2`` defines it: a
complex inverse FFT along H, then a real inverse FFT along W that reads only
the real part of the DC and Nyquist columns.  :func:`irfft2` runs those two
steps explicitly and zeroes those imaginary parts first, so the result does
not depend on how a 2-D complex-to-real FFT library treats such input.
"""

from __future__ import annotations

import torch


def rfft2(x):
    """= ``np.fft.rfft2(x, norm='forward')`` for real ``[..., h, w]``,
    returned as an (re, im) float32 pair."""
    y = torch.fft.rfft2(x.float(), norm="forward")
    return y.real.contiguous(), y.imag.contiguous()


def irfft2(x_re, x_im, s):
    """= ``np.fft.irfft2(x_re + 1j*x_im, s=s, norm='forward')`` for a
    half-spectrum ``[..., s[0], s[1]//2+1]``."""
    h, w = int(s[0]), int(s[1])
    u = torch.fft.ifft(torch.complex(x_re.float(), x_im.float()), n=h,
                       dim=-2, norm="forward")
    # 1 but at the DC and Nyquist columns, made on the device (a captured
    # CUDA graph takes no host-to-device write of a Python scalar)
    col = torch.arange(u.shape[-1], device=u.device)
    keep = (col != 0) & (col != (w // 2 if w % 2 == 0 else -1))
    u = torch.complex(u.real, u.imag * keep.to(torch.float32))
    return torch.fft.irfft(u, n=w, dim=-1, norm="forward")
