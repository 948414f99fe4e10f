"""The memory layout of an activation, as the kernel wrappers read it.

The compiled forward (``runtime/compiled.py``) holds its activations in
channels-last memory layout (NHWC strides, the logical NCHW shape
unchanged); everything else in the package runs NCHW.  The hand-written
kernels take either layout and pick their index map from the tensor's
strides: :func:`channels_last` is that test.  Where C is 1, or H and W are
both 1, the two layouts coincide and the NCHW map is taken.
"""

from __future__ import annotations

import torch

CL = torch.channels_last


def channels_last(x):
    """True iff ``x`` is a 4-D tensor laid out channels-last and not also
    NCHW-contiguous."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=CL))


def like(y, x):
    """``y`` channels-last where ``x`` keeps its channels innermost (a
    channels-last tensor or a slice of its channels), else as it is."""
    inner = (x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1
             and not x.is_contiguous())
    return y.contiguous(memory_format=CL) if inner else y


def scaled_weight(w, gain, x, transposed=False):
    """``w * gain``, written in the layout cuDNN reads it in where the conv
    input ``x`` is channels-last and ``w`` records no gradient, so no weight
    copy is added a forward: the same product, channels-last; with
    ``transposed`` (``w`` the [O, I, kh, kw] kernel of a transposed conv,
    which ``ops/conv_resample`` hands cuDNN with O and I swapped, ungrouped)
    channels-last once O and I are swapped: O innermost, then kw, kh, I."""
    if channels_last(x) and not (torch.is_grad_enabled() and w.requires_grad):
        if transposed:
            o, i, kh, kw = w.shape
            out = w.new_empty((i, kh, kw, o)).permute(3, 0, 1, 2)
        else:
            out = torch.empty_like(w, memory_format=CL)
        return torch.mul(w, gain, out=out)
    return w * gain

