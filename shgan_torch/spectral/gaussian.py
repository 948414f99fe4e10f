"""Annular Gaussian window pyramid for the SHU Gaussian-split.

Copy of ``shgan_tpu/spectral/gaussian.py`` (numpy only); upstream SH-GAN
``gaussian_heatmap_2d`` (``lib/model_zoo/shgan.py:162-250``) and the
difference-of-Gaussians pyramid in ``SHU.__init__`` (``shgan.py:281-310``).  These weight maps window the shifted half-spectrum
before each per-resolution inverse FFT so every pyramid level receives its
own frequency band.

All of this is init-time numpy; the maps become constant tensors of the
module.  The reference's 3σ-window "speedup" leaves EXACT zeros outside the
window — that windowing is part of the constants' value and is reproduced
here (not an optimization for us, but a parity requirement).
"""

from __future__ import annotations

import numpy as np


def gaussian_heatmap_2d(size, centers, variances, merge_type="max",
                        speedup=True):
    """Evaluate (and merge) anisotropic Gaussian bumps on an ``[h, w]`` grid.

    Args:
        size: (h, w).
        centers: [n, 2] float (row, col) centers.
        variances: [n, 2, 2] covariance matrices.
        merge_type: 'max' or 'add'.
        speedup: restrict evaluation to a ±(3·maxstd+1) window around the
            integer center, zero outside (reference `shgan.py:206-231`).
    """
    h, w = size
    coordh = np.arange(h, dtype=float)[:, None] * np.ones((1, w))
    coordw = np.arange(w, dtype=float)[None, :] * np.ones((h, 1))
    coord = np.stack([coordh, coordw])
    x = np.zeros((h, w), dtype=float)

    for ci, vi in zip(np.asarray(centers, float), np.asarray(variances, float)):
        ci = ci[:, None, None]
        dx = coord - ci
        if speedup:
            try:
                singv = np.linalg.svd(vi, compute_uv=False)
            except np.linalg.LinAlgError:
                continue
            maxstd = np.sqrt(np.max(singv))
            searchr = int(3 * maxstd + 1)
            chint, cwint = int(ci[0, 0, 0]), int(ci[1, 0, 0])
            sh0 = max(min(chint - searchr, h), 0)
            sh1 = max(min(chint + searchr, h), 0)
            sw0 = max(min(cwint - searchr, w), 0)
            sw1 = max(min(cwint + searchr, w), 0)
            if sh1 - sh0 == 0 or sw1 - sw0 == 0:
                continue
            dx = dx[:, sh0:sh1, sw0:sw1]
            xref = x[sh0:sh1, sw0:sw1]
            sh, sw = sh1 - sh0, sw1 - sw0
        else:
            xref = x
            sh, sw = h, w

        try:
            vi_inv = np.linalg.inv(vi)
        except np.linalg.LinAlgError:
            continue
        d = dx.transpose(1, 2, 0).reshape(-1, 2)
        q = ((d @ vi_inv) * d).sum(-1).reshape(sh, sw)
        g = np.exp(-0.5 * q)
        if merge_type == "max":
            xref[:, :] = np.maximum(xref, g)
        elif merge_type == "add":
            xref[:, :] = xref + g
        else:
            raise ValueError(merge_type)
    return x


def build_gaussian_split_maps(input_res, lowest_res=4, tail_sigma_mult=3.0,
                              gaussian_at_input_res=False):
    """Difference-of-Gaussians window pyramid over shifted half-spectra.

    Returns ``{res: float32 [res, res//2+1]}`` for res in
    ``lowest_res .. input_res`` (powers of two), reproducing the reference
    construction at `shgan.py:281-310`: each coarser level's Gaussian is
    carved out of the level above it, so the maps partition the spectrum
    into annular bands centered at DC (which, after the fftshift-by-concat,
    sits at row ``res//2-1``, col 0).
    """
    reslist = [2 ** i for i in range(int(np.log2(lowest_res)),
                                     int(np.log2(input_res)) + 1)]
    reslistrev = reslist[::-1]
    maps = {}
    for idx, resi in enumerate(reslistrev):
        if idx != 0 or gaussian_at_input_res:
            center = np.array([[resi // 2 - 1, 0]], dtype=float)
            sigma = (resi // 2) / tail_sigma_mult
            var = np.array([[[sigma ** 2, 0], [0, sigma ** 2]]], dtype=float)
            maps[resi] = gaussian_heatmap_2d((resi, resi // 2 + 1), center, var)
            if idx != 0:
                resi_prev = reslistrev[idx - 1]
                maps[resi_prev][
                    (resi_prev // 2 - resi // 2):(resi_prev // 2 + resi // 2),
                    0:(resi // 2 + 1)] -= maps[resi]
        else:
            maps[resi] = np.ones((resi, resi // 2 + 1), dtype=float)
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in maps.items()}
