"""2D convolution with fused up/downsampling (port of the direct paths of
``shgan_tpu/ops/conv_resample.py``).

The padding algebra and the fast-path order (filter before or after the
conv) are the JAX package's.  The large convolutions go to ``F.conv2d`` /
``F.conv_transpose2d`` (the JAX package left them to XLA too); every FIR
goes through :func:`.upfirdn2d.upfirdn2d`, i.e. kernel K2 on the card.

The up path: the JAX code runs an lhs-dilated correlation with ``w'`` (``w``
spatially flipped iff ``flip_weight`` is False) and padding ``k-1-pt``.  A
transposed convolution with stride ``up`` and padding ``pt`` computes the
same thing when its weight is ``w'`` flipped back and OI-transposed per
group, which :func:`_transpose_weight` builds (where ``flip_weight`` is
False the two flips cancel: the OI swap of ``w`` alone, a view that a
channels-last kernel of ``ops/layout.scaled_weight`` hands cuDNN without a
copy).
"""

from __future__ import annotations

import torch.nn.functional as F

from ..parallel.spatial import replicated
from .conv1024 import conv3x3_lowch, takes_k3
from .upfirdn2d import (fir_rows, upfirdn2d, _parse_padding,
                        _get_filter_size)


def _maybe_flip(w, flip_weight):
    """conv2d performs correlation; flipping the kernel spatially turns it
    into true convolution."""
    if not flip_weight:
        w = w.flip([2, 3])
    return w


def _conv2d(x, w, stride=1, padding=(0, 0), groups=1, flip_weight=True):
    """Plain correlation; padding=(py, px).  The low-channel 3×3 convs at
    ≥1024² that record no gradient go to kernel K3 (``conv1024.takes_k3``;
    the routing of ``shgan_tpu/ops/conv_resample.py:108-118``)."""
    w = _maybe_flip(w, flip_weight)
    if takes_k3(x, w, stride, groups, padding):
        return conv3x3_lowch(x, w)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding,
                    groups=groups)


def _transpose_weight(w, groups, flip=True):
    """[O, I/g, kh, kw] correlation kernel → the [I, O/g, kh, kw] weight of
    the equivalent transposed convolution (per-group OI swap + flip); with
    ``flip`` False, ``w`` is the convolution kernel, whose flip and the
    transposed conv's cancel: the OI swap alone, a view for one group."""
    o, ig, kh, kw = w.shape
    w = w.reshape(groups, o // groups, ig, kh, kw).transpose(1, 2)
    w = w.reshape(groups * ig, o // groups, kh, kw)
    return w.flip([2, 3]) if flip else w


def _conv2d_up(x, w, up, padding, groups=1, flip_weight=True):
    """Equivalent of the JAX lhs-dilated up conv; padding=(pyt, pxt)."""
    w = _transpose_weight(w, groups, flip=flip_weight)
    return F.conv_transpose2d(x, w.to(x.dtype), stride=up, padding=padding,
                              groups=groups)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False, slab=None, src=None):
    """2D convolution with optional up/downsampling; padding applies once,
    w.r.t. the upsampled image.

    Args:
        x: ``[N, C_in, H, W]``.
        w: ``[C_out, C_in // groups, kh, kw]``.
        f: FIR filter constant from ``setup_filter`` (None = identity).
        up, down: integer resampling factors.
        padding: signed padding w.r.t. the upsampled image.
        groups: feature groups.
        flip_weight: False = convolution, True = correlation.
        flip_filter: same, for the FIR filter.
        slab: the output rows this rank computes (a
            :class:`~shgan_torch.parallel.spatial.Slab` of the output
            plane), or None for the whole output.
        src: with ``slab``, what ``x`` holds: a Slab of the input plane
            (the rows beyond it come from the neighbours), or None for the
            whole input plane.
    """
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("conv2d_resample takes NCHW x and OIHW w")
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int)
            and down >= 1):
        raise ValueError(f"up/down must be ints >= 1, got {up}, {down}")
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    # Adjust padding for the resampling FIR (conv_resample.py:178-188).
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    if slab is not None:
        return _conv2d_resample_slab(x, w, f, up, down, (px0, px1, py0, py1),
                                     groups, flip_weight, flip_filter, slab,
                                     src)

    # 1x1 conv + downsample: downsample first (cheaper conv).
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)

    # 1x1 conv + upsample: convolve first.
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1],
                         gain=up ** 2, flip_filter=flip_filter)

    # Downsample: blur, then a strided conv.
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups,
                       flip_weight=flip_weight)

    # Upsample (optional extra downsample): transposed conv, then blur.
    if up > 1:
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        x = _conv2d_up(x, w, up=up, padding=(pyt, pxt), groups=groups,
                       flip_weight=flip_weight)
        x = upfirdn2d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt,
                                     py1 + pyt],
                      gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain conv with symmetric non-negative padding.
    if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return _conv2d(x, w, padding=(py0, px0), groups=groups,
                       flip_weight=flip_weight)

    # Signed (asymmetric or negative) padding: pad, then a valid conv.
    x = upfirdn2d(x, None, padding=[px0, px1, py0, py1])
    return _conv2d(x, w, groups=groups, flip_weight=flip_weight)


def _conv2d_resample_slab(x, w, f, up, down, pads, groups, flip_weight,
                          flip_filter, slab, src):
    """:func:`conv2d_resample` for output rows ``[slab.h0, slab.h1)``: the
    H padding becomes the rows of the plane beyond the slab (the halo, zeros
    past the plane's edges), and each op runs valid in H.  The paths are
    the unsharded one's: 1x1 without resampling, a stride-1 conv (K3 where
    the whole plane is eligible), the down path (blur, strided conv) and
    the up path (transposed conv, blur)."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fh = _get_filter_size(f)[1]
    px0, px1, py0, py1 = pads
    o0, o1 = slab.h0, slab.h1
    w = replicated(w, slab)
    if up == 1 and down == 1:
        if px0 != px1 or py0 != py1 or px0 < 0 or py0 < 0:
            raise NotImplementedError("a slab conv takes symmetric "
                                      "non-negative padding")
        xr = slab.read(x, src, o0 - py0, o1 - py0 + kh - 1)
        n, c, _, wd = xr.shape
        if (py0, px0) == (1, 1) and takes_k3(
                xr, w, 1, groups, (1, 1), shape=(n, c, slab.H, wd)):
            return conv3x3_lowch(xr.contiguous(),
                                 _maybe_flip(w, flip_weight), halo=1)
        return _conv2d(xr, w, padding=(0, px0), groups=groups,
                       flip_weight=flip_weight)
    if down > 1 and up == 1 and kh > 1:
        # blur rows [down*o0, down*(o1-1) + kh), then the strided conv
        b0, b1 = down * o0, down * (o1 - 1) + kh
        xb = fir_rows(x, src, slab, b0, b1, f, 1, 1, (px0, px1, py0, py1),
                      flip_filter=flip_filter)
        return _conv2d(xb, w, stride=down, groups=groups,
                       flip_weight=flip_weight)
    if up > 1 and down == 1 and kh > 1:
        # transposed conv over the input rows the output rows read, then
        # the blur with the H pads the slab's rows need
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        pxt = max(min(-px0, -px1), 0)
        a = -(-(o0 - py0 - kh + 1) // up)
        b = (o1 - 1 - py0 + fh - 1) // up + 1
        xr = slab.read(x, src, a, b)
        t = _conv2d_up(xr, w, up=up, padding=(0, pxt), groups=groups,
                       flip_weight=flip_weight)
        top = up * a + py0 - o0
        bottom = (o1 - o0) - t.shape[2] - top + fh - 1
        return upfirdn2d(t, f, padding=[px0 + pxt, px1 + pxt, top, bottom],
                         gain=up ** 2, flip_filter=flip_filter)
    raise NotImplementedError(f"conv2d_resample on a slab: {kh}x{kw} with "
                              f"up {up}, down {down}")
