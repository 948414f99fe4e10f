"""Low-channel 3×3 convolution at 1024² (port of ``shgan_tpu/ops/conv1024.py``).

The full-width channel plan gives the top pyramid level of ``shgan_g1024``
32 channels.  The JAX package routes the 3×3, stride-1, pad-1 convs of that
level to its Pallas kernel ``conv3x3_lowch`` when switched on; this module
keeps the same eligibility rule (:func:`conv1024_eligible`), so both
packages pick the same convs.  :func:`takes_k3` is the route: an eligible
conv runs on K3 wherever it records no gradient (K3 is forward-only), and
on the library conv where it does.  No switch chooses it.

:func:`conv3x3_lowch` launches kernel K3 (``csrc/conv3x3_lowch.cu``) on a
CUDA tensor and runs :func:`conv3x3_lowch_plain`, the plain PyTorch version
of the same function, on a CPU tensor.  Both take an NCHW or a
channels-last ``x`` (``ops/layout.py``) and return the result in its
layout; the kernel stages its tiles through the matching index map.  K3 is
forward-only, like the TPU kernel.

On a slab of an H-sharded plane (``parallel/spatial.py``) the conv takes
its input with a row of each neighbour's above and below (``halo=1``):
eligibility is decided on the whole plane, so both packages route the same
convs, and K3 pads only W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build as _kb
from .layout import CL, channels_last, like

BH = 8          # the TPU kernel's row block: kept in the eligibility rule
MIN_RES = 1024  # below this the JAX package keeps the XLA conv
MAX_CH = 32


def conv1024_eligible(x_shape, w_shape, stride, groups, padding):
    """True iff the conv is in K3's class: 3×3, stride 1, pad 1, groups 1,
    C_in and C_out ≤ 32, H = W ≥ MIN_RES, H divisible by the TPU kernel's
    row block (``conv1024.py:72-82``)."""
    _, c, h, wd = x_shape
    oc, _, kh, kw = w_shape
    return (stride == 1 and groups == 1 and (kh, kw) == (3, 3)
            and tuple(padding) == (1, 1) and c <= MAX_CH and oc <= MAX_CH
            and h == wd and h >= MIN_RES and h % BH == 0)


def takes_k3(x, w, stride, groups, padding, shape=None):
    """True iff the conv of ``x`` by ``w`` runs on K3: it is eligible
    (:func:`conv1024_eligible` on ``shape``, the whole plane's for a slab;
    by default ``x``'s) and records no gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return False
    return conv1024_eligible(x.shape if shape is None else shape, w.shape,
                             stride, groups, padding)


def conv3x3_lowch_plain(x, w, halo=0):
    """Plain PyTorch version of K3: Σ over the nine taps of a channel
    contraction with the shifted padded input, summed in float32, cast to
    ``x.dtype``.  ``w`` is the [O, C, 3, 3] correlation kernel; ``halo=1``:
    ``x`` holds a row above and below the output's (padded in W only).  A
    channels-last ``x`` is computed as NCHW and the result returned
    channels-last."""
    src, x = x, x.contiguous()
    n, c, h, wd = x.shape
    h -= 2 * halo
    wf = w.to(x.dtype).float()
    xp = F.pad(x.float(), (1, 1, 1 - halo, 1 - halo))
    y = None
    for dy in range(3):
        for dx in range(3):
            term = torch.einsum("oc,nchw->nohw", wf[:, :, dy, dx],
                                xp[:, :, dy:dy + h, dx:dx + wd])
            y = term if y is None else y + term
    return like(y.to(x.dtype), src)


def _check(x, w, halo=0):
    if halo not in (0, 1):
        raise ValueError(f"conv3x3_lowch takes halo 0 or 1, got {halo}")
    if halo and (x.ndim != 4 or x.shape[2] <= 2 or (x.shape[2] - 2) % BH):
        raise ValueError(f"conv3x3_lowch on a slab needs {BH} | its rows, "
                         f"got {tuple(x.shape)} with a halo of 1")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3_lowch takes NCHW x and [O,C,3,3] w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.shape[1] > MAX_CH or w.shape[0] > MAX_CH:
        raise ValueError(f"conv3x3_lowch takes at most {MAX_CH} channels in "
                         f"and out, got {x.shape[1]} -> {w.shape[0]}")


def conv3x3_lowch_cuda(x, w, halo=0):
    """Launch kernel K3 (``csrc/conv3x3_lowch.cu``) on a CUDA tensor."""
    _check(x, w, halo)
    if not x.is_cuda or w.device != x.device:
        raise ValueError("conv3x3_lowch_cuda needs x and w on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_lowch kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    nhwc = channels_last(x)
    if not (x.is_contiguous() or nhwc):
        raise ValueError("conv3x3_lowch kernel needs a contiguous NCHW or "
                         "channels-last x")
    if nhwc and x.dtype == torch.bfloat16 and x.shape[1] % 2:
        raise ValueError("conv3x3_lowch kernel: a channels-last bfloat16 x "
                         "needs an even channel count")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("the conv3x3_lowch kernel is forward-only; run "
                           "under torch.inference_mode()")
    n, c, h, wd = x.shape
    h -= 2 * halo
    o = w.shape[0]
    # the kernel reads float32 weights; rounding them to x.dtype first keeps
    # the JAX package's `w.astype(x.dtype)` (exact for float32)
    wk = w.to(x.dtype).float().contiguous()
    y = torch.empty((n, o, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=CL if nhwc else torch.contiguous_format)
    rc = _kb.launch(_kb.library("conv3x3_lowch").shgan_conv3x3_lowch,
                    x.device, x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                    0 if x.dtype == torch.float32 else 1, n, c, o, h, wd,
                    halo, int(nhwc))
    _kb.check(rc, "conv3x3_lowch kernel")
    _kb.count("conv3x3_lowch", nhwc)
    return y


def conv3x3_lowch(x, w, halo=0):
    """3×3 same-padding correlation, NCHW or channels-last, stride 1,
    C_in/C_out ≤ 32
    (``halo=1``: ``x`` a slab with a row above and below, pad 1 in W only):
    kernel K3 on a CUDA tensor (or raise), the plain version on a CPU
    tensor."""
    if x.is_cuda:
        return conv3x3_lowch_cuda(x, w, halo)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_lowch runs on CUDA or the CPU, not "
                         f"{x.device}")
    _check(x, w, halo)
    return conv3x3_lowch_plain(x, w, halo)
