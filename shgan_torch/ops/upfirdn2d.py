"""Pad → zero-insert upsample → 2D FIR filter → decimate (upfirdn2d).

Port of ``shgan_tpu/ops/upfirdn2d.py``: the same argument parsing, the same
output-size arithmetic and signed padding (negative pad = crop), the same
convenience wrappers.  The contract:

  1. upsample by inserting ``up-1`` zeros after every pixel,
  2. apply signed padding w.r.t. the upsampled image,
  3. convolve with the FIR filter ``f`` (flip_filter=False: true convolution),
  4. keep every ``down``-th pixel.

Every call lands in :func:`fir`, which takes the filter as 2D correlation
taps (flip and gain already folded in on the host).  On a CUDA tensor it
launches the hand-written kernel ``csrc/upfirdn2d.cu`` (kernel K2, the port
of the TPU kernel ``shgan_tpu/ops/fir_pallas.py::_pallas_fir``, widened to
the whole contract); on a CPU tensor it runs :func:`fir_plain`, the plain
PyTorch version of the same function.

The gradient (the counterpart of the custom VJP at
``shgan_tpu/ops/fir_pallas.py:134-159``): upfirdn2d is linear in ``x``, and
its adjoint is upfirdn2d again with the taps reversed, ``up`` and ``down``
swapped and the pads of :func:`grad_pads`.  :class:`_Fir` applies itself to
the cotangent, so the backward, the double backward (R1, path length) and
any higher order are kernel K2 too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import build as _kb

# ---------------------------------------------------------------------------
# argument parsing helpers (contract of shgan_tpu/ops/upfirdn2d.py:39-64)
# ---------------------------------------------------------------------------


def _parse_scaling(scaling):
    if isinstance(scaling, (int, np.integer)):
        scaling = [int(scaling)] * 2
    sx, sy = (int(s) for s in scaling)
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling factors must be >= 1, got {scaling}")
    return sx, sy


def _parse_padding(padding):
    if isinstance(padding, (int, np.integer)):
        padding = [int(padding)] * 2
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return padx0, padx1, pady0, pady1


def _get_filter_size(f):
    if f is None:
        return 1, 1
    fw = int(f.shape[-1])
    fh = int(f.shape[0])
    return fw, fh


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None):
    """Prepare a FIR filter constant: float32 numpy, 1D ``[taps]`` if
    separable else 2D ``[fh, fw]``; normalized to unit sum, optionally
    flipped, scaled by ``gain ** (ndim / 2)`` (shgan_tpu/ops/upfirdn2d.py:71-99)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim not in (0, 1, 2) or f.size == 0:
        raise ValueError(f"bad filter shape {f.shape}")
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = (f.ndim == 1 and f.size >= 8)
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if f.ndim != (1 if separable else 2):
        raise ValueError("separable filters must be 1D")
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[tuple(slice(None, None, -1) for _ in range(f.ndim))]
    f = f * (gain ** (f.ndim / 2))
    return np.ascontiguousarray(f, dtype=np.float32)


def correlation_taps(f, flip_filter=False, gain=1):
    """The 2D correlation taps that upfirdn2d applies for filter ``f``: the
    filter scaled by ``gain`` in total (``sqrt(gain)`` per axis of a 1D
    filter), flipped unless ``flip_filter`` (true convolution)."""
    f = np.ones((1, 1), np.float32) if f is None else np.asarray(f, np.float64)
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1D or 2D, got {f.shape}")
    f = f * (gain ** (f.ndim / 2))
    if f.ndim == 1:
        f = np.outer(f, f)
    if not flip_filter:
        f = f[::-1, ::-1]
    return np.array(f, dtype=np.float32, order="C")  # a copy, positive strides


def out_size(n_in, up, down, pad0, pad1, taps):
    """Output extent along one axis (shgan_tpu/ops/upfirdn2d.py:193-195)."""
    return (n_in * up + pad0 + pad1 - taps) // down + 1


# ---------------------------------------------------------------------------
# the kernel (K2) and its plain version
# ---------------------------------------------------------------------------


def fir_plain(x, taps, up=(1, 1), down=(1, 1), pads=(0, 0, 0, 0)):
    """Plain PyTorch upfirdn2d with 2D correlation ``taps``: zero-insert,
    signed pad, depthwise correlation, decimate.  Runs on any device; the
    sum is taken in float32 and cast back to ``x.dtype``."""
    upx, upy = up
    downx, downy = down
    padx0, padx1, pady0, pady1 = pads
    n, c, h, w = x.shape
    dtype = x.dtype
    x = x.float()
    if upx > 1 or upy > 1:
        z = x.new_zeros((n, c, h * upy, w * upx))
        z[:, :, ::upy, ::upx] = x
        x = z
    # F.pad takes (left, right, top, bottom); negative values crop
    x = F.pad(x, [padx0, padx1, pady0, pady1])
    fh, fw = taps.shape
    k = torch.tensor(np.array(taps, dtype=np.float32, order="C"),
                     device=x.device)
    k = k[None, None].expand(c, 1, fh, fw)
    y = F.conv2d(x, k, stride=(downy, downx), groups=c)
    return y.to(dtype)


def fir_cuda(x, taps, up=(1, 1), down=(1, 1), pads=(0, 0, 0, 0),
             counter="upfirdn2d"):
    """Launch kernel K2 (``csrc/upfirdn2d.cu``) on a CUDA tensor; the launch
    counts under ``counter`` (``"upfirdn2d_grad"`` for a derivative)."""
    if not x.is_cuda:
        raise ValueError("fir_cuda needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upfirdn2d kernel takes float32/bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d kernel needs a contiguous NCHW tensor")
    upx, upy = up
    downx, downy = down
    padx0, padx1, pady0, pady1 = pads
    fh, fw = taps.shape
    if max(fh, fw) > 8 or not {upx, upy, downx, downy} <= {1, 2}:
        raise ValueError(f"upfirdn2d kernel: taps {taps.shape}, up {up}, "
                         f"down {down} outside its range (<=8x8 taps, 1 or 2)")
    n, c, h, w = x.shape
    oh = out_size(h, upy, downy, pady0, pady1, fh)
    ow = out_size(w, upx, downx, padx0, padx1, fw)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty upfirdn2d output {oh}x{ow}")
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    t = np.array(taps, dtype=np.float32, order="C")
    rc = _kb.launch(
        _kb.library("upfirdn2d").shgan_upfirdn2d, x.device, x.data_ptr(),
        y.data_ptr(), 0 if x.dtype == torch.float32 else 1, n * c, h, w, oh,
        ow, upx, upy, downx, downy, padx0, pady0,
        t.ctypes.data_as(ctypes.c_void_p), fh, fw)
    _kb.check(rc, "upfirdn2d kernel")
    _kb.count(counter)
    return y


def _fir_any(x, taps, up, down, pads, counter):
    if x.is_cuda:
        return fir_cuda(x, taps, up, down, pads, counter)
    if x.device.type != "cpu":
        raise ValueError(f"upfirdn2d runs on CUDA or the CPU, not {x.device}")
    return fir_plain(x, taps, up, down, pads)


def grad_pads(h, w, taps, up, down, pads):
    """The pads of the adjoint call: for an input ``h x w`` and the forward's
    taps, factors and pads, the call on the cotangent with reversed taps and
    ``up``/``down`` swapped that gives back an ``h x w`` gradient."""
    fh, fw = taps.shape
    upx, upy = up
    downx, downy = down
    px0, px1, py0, py1 = pads
    oh = out_size(h, upy, downy, py0, py1, fh)
    ow = out_size(w, upx, downx, px0, px1, fw)
    return (fw - px0 - 1, w * upx - ow * downx + px0 - upx + 1,
            fh - py0 - 1, h * upy - oh * downy + py0 - upy + 1)


class _Fir(torch.autograd.Function):
    """upfirdn2d with a gradient: the forward is K2 (or the plain version on
    the CPU); the backward is this Function on the cotangent."""

    @staticmethod
    def forward(ctx, x, taps, up, down, pads, counter):
        ctx.meta = (taps, up, down, pads, x.shape[2], x.shape[3])
        return _fir_any(x, taps, up, down, pads, counter)

    @staticmethod
    def backward(ctx, dy):
        taps, up, down, pads, h, w = ctx.meta
        flipped = np.ascontiguousarray(taps[::-1, ::-1])
        dx = _Fir.apply(dy.contiguous(), flipped, down, up,
                        grad_pads(h, w, taps, up, down, pads),
                        "upfirdn2d_grad")
        return dx, None, None, None, None, None


def fir(x, taps, up=(1, 1), down=(1, 1), pads=(0, 0, 0, 0)):
    """upfirdn2d with 2D correlation taps: kernel K2 on a CUDA tensor (or
    raise), the plain version on a CPU tensor; differentiable where ``x``
    needs a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Fir.apply(x, taps, tuple(up), tuple(down), tuple(pads),
                          "upfirdn2d")
    return _fir_any(x, taps, up, down, pads, "upfirdn2d")


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """Pad, upsample, FIR-filter and downsample a batch of NCHW images.

    Args:
        x: ``[N, C, H, W]`` tensor.
        f: float FIR filter (numpy), ``[fh, fw]``, ``[taps]`` (separable) or
           None (identity).
        up / down: int or (x, y) int pair.
        padding: int, ``[x, y]`` or ``[x0, x1, y0, y1]``, signed, w.r.t. the
           upsampled image.
        flip_filter: False = convolution, True = correlation.
        gain: overall scaling factor.

    Returns ``[N, C, outH, outW]`` with
    ``outH = (H*upy + pady0 + pady1 - fh) // downy + 1``.
    """
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d takes NCHW, got {tuple(x.shape)}")
    up = _parse_scaling(up)
    down = _parse_scaling(down)
    pads = _parse_padding(padding)
    taps = correlation_taps(f, flip_filter=flip_filter, gain=gain)
    return fir(x.contiguous(), taps, up, down, pads)


# ---------------------------------------------------------------------------
# convenience wrappers (padding algebra of shgan_tpu/ops/upfirdn2d.py:300-339)
# ---------------------------------------------------------------------------


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """FIR-filter with output shape matching input."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Upsample by ``up`` with FIR smoothing."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """Downsample by ``down`` with FIR anti-aliasing."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
