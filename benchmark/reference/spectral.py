"""The SHU's spectral constants, frozen copies of SH-GAN's construction
(``lib/model_zoo/shgan.py``): the heterogeneous filter's basis maps (a
one-hot control grid, reflect-padded and grid-sampled over the
half-spectrum) and the difference-of-Gaussians split maps of the
half-spectrum pyramid.  numpy only; nothing here imports the program."""

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


def cweight(half_size, half_sample, type="piecewise_linear"):
    return make_cweight(half_size, half_sample, type)


def gaussian_split_maps(input_res, lowest_res=4, tail_sigma_mult=3.0,
                        gaussian_at_input_res=False):
    return build_gaussian_split_maps(input_res, lowest_res, tail_sigma_mult,
                                     gaussian_at_input_res)
