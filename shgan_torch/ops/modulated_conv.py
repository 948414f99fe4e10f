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

A conv whose input already holds ``x ⊙ styles`` (``prescaled``: the epilogue
before it wrote it, ``models/synthesis.py``'s no-grad route) skips the
multiply; :func:`normalize_styles` gives the styles it was scaled by.  Each
call is counted in ``kernels/build.modconv``, prescaled or multiplied.
"""

from __future__ import annotations

import torch

from ..kernels import build as _kb
from ..parallel.spatial import replicated
from .conv_resample import conv2d_resample
from .layout import scaled_weight


def normalize_styles(styles, rows=None):
    """A demodulated conv's styles at unit RMS over all their elements, the
    batch's included (``rows``: this worker's rows of a global batch, whose
    styles are gathered for the mean)."""
    whole = styles if rows is None else rows.gather(styles)
    return styles * torch.rsqrt(whole.square().mean())


def demod_coefs(weight, styles):
    """The dcoefs ``[N, O]`` of the scaled ``weight`` and the normalized
    ``styles``: the weight's squares written NCHW whatever its layout, so
    the sum runs as on an NCHW weight and both layouts give the same
    dcoefs bit for bit."""
    sq = weight.square() if weight.is_contiguous() else torch.square(
        weight, out=torch.empty(weight.shape, dtype=weight.dtype,
                                device=weight.device))
    wsq = sq.sum(dim=(2, 3))                                 # [O, I]
    return torch.rsqrt(styles.square() @ wsq.t() + 1e-8)


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True,
                     split_dcoefs=False, rows=None, slab=None, src=None,
                     prescaled=False):
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
        prescaled: ``x`` already holds ``x ⊙ styles`` for exactly these
            styles (with demodulation, the normalized ones:
            :func:`normalize_styles`, taken as given), so the multiply is
            skipped.
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
        if not prescaled:
            styles = normalize_styles(styles, rows)
        dcoefs = demod_coefs(weight, styles)

    _kb.count_modconv(prescaled)
    if not prescaled:
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
