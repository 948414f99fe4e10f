"""Low-channel 3×3 convolution at 1024² (port of ``shgan_tpu/ops/conv1024.py``).

The full-width channel plan gives the top pyramid level of ``shgan_g1024``
32 channels.  The JAX package routes the 3×3, stride-1, pad-1 convs of that
level to its Pallas kernel ``conv3x3_lowch`` when switched on; this module
keeps the same switch (:func:`set_conv1024_impl`, with the
``SHGAN_CONV1024`` environment override) and the same eligibility rule
(:func:`conv1024_eligible`), so both packages route the same convs.  Off by
default, as in JAX; the eval stage turns it on from ``eval.pallas_conv1024``
on a CUDA device.

:func:`conv3x3_lowch` launches kernel K3 (``csrc/conv3x3_lowch.cu``) on a
CUDA tensor and runs :func:`conv3x3_lowch_plain`, the plain PyTorch version
of the same function, on a CPU tensor.  K3 is forward-only, like the TPU
kernel.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..kernels import build as _kb

BH = 8          # the TPU kernel's row block: kept in the eligibility rule
MIN_RES = 1024  # below this the JAX package keeps the XLA conv
MAX_CH = 32

_IMPL = "xla"


def set_conv1024_impl(impl):
    """'pallas' routes eligible low-channel ≥1024² convs through
    :func:`conv3x3_lowch` (kernel K3 on the card); 'xla' restores the
    library conv.  The names are the JAX package's.  The environment
    override ``SHGAN_CONV1024`` wins."""
    global _IMPL
    if impl not in ("pallas", "xla"):
        raise ValueError(f"conv1024 impl {impl!r}: 'pallas' or 'xla'")
    _IMPL = os.environ.get("SHGAN_CONV1024", impl)


def conv1024_impl():
    """The routing now in force: 'pallas' (K3) or 'xla' (library conv)."""
    return _IMPL


def conv1024_eligible(x_shape, w_shape, stride, groups, padding):
    """True iff the switch is on and the conv is in K3's routed class:
    3×3, stride 1, pad 1, groups 1, C_in and C_out ≤ 32, H = W ≥ MIN_RES,
    H divisible by the TPU kernel's row block (``conv1024.py:72-82``)."""
    if _IMPL != "pallas":
        return False
    _, c, h, wd = x_shape
    oc, _, kh, kw = w_shape
    return (stride == 1 and groups == 1 and (kh, kw) == (3, 3)
            and tuple(padding) == (1, 1) and c <= MAX_CH and oc <= MAX_CH
            and h == wd and h >= MIN_RES and h % BH == 0)


def conv3x3_lowch_plain(x, w):
    """Plain PyTorch version of K3: Σ over the nine taps of a channel
    contraction with the shifted padded input, summed in float32, cast to
    ``x.dtype``.  ``w`` is the [O, C, 3, 3] correlation kernel."""
    n, c, h, wd = x.shape
    wf = w.to(x.dtype).float()
    xp = F.pad(x.float(), (1, 1, 1, 1))
    y = None
    for dy in range(3):
        for dx in range(3):
            term = torch.einsum("oc,nchw->nohw", wf[:, :, dy, dx],
                                xp[:, :, dy:dy + h, dx:dx + wd])
            y = term if y is None else y + term
    return y.to(x.dtype)


def _check(x, w):
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3_lowch takes NCHW x and [O,C,3,3] w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.shape[1] > MAX_CH or w.shape[0] > MAX_CH:
        raise ValueError(f"conv3x3_lowch takes at most {MAX_CH} channels in "
                         f"and out, got {x.shape[1]} -> {w.shape[0]}")


def conv3x3_lowch_cuda(x, w):
    """Launch kernel K3 (``csrc/conv3x3_lowch.cu``) on a CUDA tensor."""
    _check(x, w)
    if not x.is_cuda or w.device != x.device:
        raise ValueError("conv3x3_lowch_cuda needs x and w on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_lowch kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_lowch kernel needs a contiguous NCHW x")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("the conv3x3_lowch kernel is forward-only; run "
                           "under torch.inference_mode()")
    n, c, h, wd = x.shape
    o = w.shape[0]
    # the kernel reads float32 weights; rounding them to x.dtype first keeps
    # the JAX package's `w.astype(x.dtype)` (exact for float32)
    wk = w.to(x.dtype).float().contiguous()
    y = torch.empty((n, o, h, wd), dtype=x.dtype, device=x.device)
    rc = _kb.launch(_kb.library("conv3x3_lowch").shgan_conv3x3_lowch,
                    x.device, x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                    0 if x.dtype == torch.float32 else 1, n, c, o, h, wd)
    _kb.check(rc, "conv3x3_lowch kernel")
    _kb.count("conv3x3_lowch")
    return y


def conv3x3_lowch(x, w):
    """3×3 same-padding correlation, NCHW, stride 1, C_in/C_out ≤ 32:
    kernel K3 on a CUDA tensor (or raise), the plain version on a CPU
    tensor."""
    if x.is_cuda:
        return conv3x3_lowch_cuda(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_lowch runs on CUDA or the CPU, not "
                         f"{x.device}")
    _check(x, w)
    return conv3x3_lowch_plain(x, w)
