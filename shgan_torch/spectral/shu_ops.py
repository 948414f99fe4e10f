"""Spectral Hint Unit ops (port of ``shgan_tpu/spectral/shu_ops.py``): the
heterogeneous filter and the shift/unshift-by-concat of the half-spectrum."""

from __future__ import annotations

import torch


def heterogeneous_filter_apply(weight, x, cweight, out_channels):
    """Frequency-dependent 1×1 channel transform
    ``o[n,o,h,w] = Σ_i Σ_f x[n,i,h,w] · W[i,o,f] · cw[f,h,w]``.

    Args:
        weight: [in_channels, out_channels * F] parameter.
        x: [N, in_channels, h, w].
        cweight: [F, h, w] basis maps (tensor on x's device).
        out_channels: number of output channels.
    """
    ic = x.shape[1]
    f = cweight.shape[0]
    wi_of = weight.reshape(ic, out_channels, f).to(x.dtype)
    return torch.einsum("nihw,iof,fhw->nohw", x, wi_of, cweight.to(x.dtype))


def spectral_shift(ff):
    """Rows [H//2+1:] then rows [:H//2+1] (DC moves to row H//2-1)."""
    h = ff.shape[2]
    return torch.cat([ff[:, :, h // 2 + 1:], ff[:, :, :h // 2 + 1]], dim=2)


def spectral_unshift(ff, res):
    """Inverse of the shift for a ``res``-row half-spectrum."""
    k = res - res // 2 - 1
    return torch.cat([ff[:, :, k:], ff[:, :, :k]], dim=2)
