"""Modulated / demodulated convolution (StyleGAN2 core op), port of the
unfolded path of ``shgan_tpu/ops/modulated_conv.py``.

Activation-scaling form: ``y = dcoef ⊙ conv(x ⊙ styles, weight) + noise``,
with the demodulation coefficients computed without per-sample weights::

    dcoef[n,o] = rsqrt( Σ_i (Σ_{kh,kw} w[o,i]²) · s[n,i]² + 1e-8 )

Note the style pre-normalization takes a global mean over the whole batch
(as the JAX package and the reference do), so rows padded onto a ragged
request change the real rows' output: compare at equal batch layout.  A
worker holding rows of a larger batch (``rows``: a rank of a data-parallel
run) takes the mean over that whole batch, as a device mesh does: it
gathers the batch's styles (``[N, I]``, small) and reduces them as one
device would.
"""

from __future__ import annotations

import torch

from ..parallel.spatial import replicated
from .conv_resample import conv2d_resample
from .layout import scaled_weight


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True,
                     split_dcoefs=False, rows=None, slab=None, src=None):
    """
    Args:
        x:       [N, I, H, W] input activations.
        weight:  [O, I, kh, kw] convolution weights.
        styles:  [N, I] modulation coefficients.
        noise:   optional tensor broadcastable to the output, added.
        up/down/padding/resample_filter: as in :func:`conv2d_resample`.
        demodulate: apply weight demodulation.
        flip_weight: False = convolution, True = correlation.
        split_dcoefs: return ``(conv output, dcoefs [N, O] float32)`` with
            neither the dcoefs nor any noise applied (dcoefs None without
            demodulation), for a caller that fuses them into its epilogue.
        rows:    this worker's :class:`~shgan_torch.parallel.Rows` of a
            global batch (the style mean's scope), or None.
        slab, src: the output rows this rank computes and what ``x``
            holds (:func:`~shgan_torch.ops.conv_resample.conv2d_resample`);
            the styles, weight and dcoefs read by slab ops get their
            gradients summed over the model group.
    """
    n = x.shape[0]
    i_ch = weight.shape[1]
    if tuple(styles.shape) != (n, i_ch):
        raise ValueError(f"styles {tuple(styles.shape)} != {(n, i_ch)}")

    dcoefs = None
    if demodulate:
        # weight to unit RMS over [I, kh, kw]; styles to unit RMS over ALL
        # elements (batch included)
        # written in the layout the conv reads it in (ops/layout.py)
        weight = scaled_weight(
            weight, torch.rsqrt(weight.square().mean(dim=(1, 2, 3),
                                                     keepdim=True)),
            x, transposed=up > 1 and weight.shape[2:] != (1, 1))
        whole = styles if rows is None else rows.gather(styles)
        styles = styles * torch.rsqrt(whole.square().mean())
        # the dcoefs from the same values, their squares written NCHW
        # whatever the weight's layout: the sum then runs as on an NCHW
        # weight, so both layouts give the same dcoefs bit for bit
        sq = weight.square() if weight.is_contiguous() else torch.square(
            weight, out=torch.empty(weight.shape, dtype=weight.dtype,
                                    device=weight.device))
        wsq = sq.sum(dim=(2, 3))                                 # [O, I]
        dcoefs = torch.rsqrt(styles.square() @ wsq.t() + 1e-8)  # [N, O]

    x = x * replicated(styles, src).to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight,
                        slab=slab, src=src)
    dcoefs_slab = replicated(dcoefs, slab)
    if split_dcoefs:
        if noise is not None:
            raise ValueError("split_dcoefs leaves the noise to the caller")
        return x, dcoefs
    if demodulate and noise is not None:
        return torch.addcmul(noise.to(x.dtype), x,
                             dcoefs_slab.to(x.dtype)[:, :, None, None])
    if demodulate:
        return x * dcoefs_slab.to(x.dtype)[:, :, None, None]
    if noise is not None:
        return x + noise.to(x.dtype)
    return x
