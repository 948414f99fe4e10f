"""Coordinate-based spectral weighting basis (the "heterogeneous" part of the
heterogeneous filter).

Copy of ``shgan_tpu/spectral/cweight.py`` (numpy only); upstream SH-GAN
``make_cweight``, ``lib/model_zoo/shgan.py:70-121``.
Given a small control grid of ``fh × fw`` degrees of freedom, produce
``fh·fw`` spatial basis maps over the half-spectrum ``[hs, ws]`` by bilinear /
bicubic interpolation of the one-hot control points — i.e. a partition-of-
unity whose weighted sum yields a smoothly frequency-dependent filter.

These are constants (the spectrum size is static per resolution), built
once in numpy when the module is constructed.
"""

from __future__ import annotations

import numpy as np


def _reflect_pad_w(x, pad):
    """Reflect-pad the last axis on the left by ``pad`` (torch 'reflect')."""
    if pad == 0:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, 0)], mode="reflect")


def _cubic_kernel(t, a=-0.75):
    """Cubic convolution kernel (torch bicubic uses a = -0.75)."""
    at = np.abs(t)
    at2 = at * at
    at3 = at2 * at
    w = np.where(
        at <= 1,
        (a + 2) * at3 - (a + 3) * at2 + 1,
        np.where(at < 2, a * at3 - 5 * a * at2 + 8 * a * at - 4 * a, 0.0),
    )
    return w


def grid_sample_2d(inp, grid, mode="bilinear", align_corners=True,
                   padding_mode="border"):
    """Numpy re-implementation of ``F.grid_sample`` for 3D input [C, H, W]
    and grid [Hg, Wg, 2] (x, y order, normalized to [-1, 1]).

    Supports the configurations used by ``make_cweight``:
    bilinear/bicubic, align_corners=True, padding_mode='border'.
    """
    assert align_corners and padding_mode == "border"
    C, H, W = inp.shape
    gx = np.asarray(grid[..., 0], dtype=np.float64)
    gy = np.asarray(grid[..., 1], dtype=np.float64)
    # align_corners=True: -1 → 0, +1 → size-1
    fx = (gx + 1) / 2 * (W - 1)
    fy = (gy + 1) / 2 * (H - 1)

    def at(iy, ix):
        iy = np.clip(iy, 0, H - 1)
        ix = np.clip(ix, 0, W - 1)
        return inp[:, iy, ix]  # [C, Hg, Wg]

    if mode == "bilinear":
        x0 = np.floor(fx).astype(np.int64)
        y0 = np.floor(fy).astype(np.int64)
        tx = fx - x0
        ty = fy - y0
        out = (
            at(y0, x0) * (1 - tx) * (1 - ty)
            + at(y0, x0 + 1) * tx * (1 - ty)
            + at(y0 + 1, x0) * (1 - tx) * ty
            + at(y0 + 1, x0 + 1) * tx * ty
        )
        return out

    if mode == "bicubic":
        x0 = np.floor(fx).astype(np.int64)
        y0 = np.floor(fy).astype(np.int64)
        tx = fx - x0
        ty = fy - y0
        out = np.zeros((C,) + fx.shape, dtype=np.float64)
        for dy in range(-1, 3):
            wy = _cubic_kernel(dy - ty)
            for dx in range(-1, 3):
                wx = _cubic_kernel(dx - tx)
                out = out + at(y0 + dy, x0 + dx) * (wx * wy)
        return out

    raise NotImplementedError(mode)


def make_cweight(half_size, half_sample, type="piecewise_linear",
                 oddeven_aligned=True):
    """Build the ``[fh·fw, hs, ws]`` float32 basis-map stack.

    Matches the reference construction (`shgan.py:94-121`): a one-hot of the
    ``h0×w0`` control grid, reflect-padded across the width so the reference
    covers the full [-1, 1]² plane, then grid-sampled at the half-spectrum
    coordinates (height normalized to (-1, 1] with odd/even alignment, width
    to [0, 1]).
    """
    h0, w0 = half_size
    hs, ws = half_sample

    ref_oh = np.zeros((h0 * w0, h0, w0), dtype=np.float64)
    for i in range(h0 * w0):
        ref_oh[i, i // w0, i % w0] = 1.0
    ref_oh = _reflect_pad_w(ref_oh, w0 - 1)

    if oddeven_aligned and hs % 2 == 0:
        h_grid = np.array([-1 + i / hs * 2 for i in range(hs + 1)])[1:]
    else:
        h_grid = np.array([-1 + i / (hs - 1) * 2 for i in range(hs)])
    w_grid = np.array([i / (ws - 1) for i in range(ws)])
    w_grid, h_grid = np.meshgrid(w_grid, h_grid)
    grid = np.stack([w_grid, h_grid], axis=-1)  # [hs, ws, (x, y)]

    mode = {"piecewise_linear": "bilinear", "bicubic": "bicubic"}[type]
    cw = grid_sample_2d(ref_oh, grid, mode=mode)
    return np.ascontiguousarray(cw, dtype=np.float32)
