"""Per-layer noise injection RNG: counter-based Philox4x32-10 + Box–Muller.

Port of ``shgan_tpu/ops/noise.py``.  Kernel K1 (``csrc/noise.cu``) replaces
the TPU kernel ``_pallas_normal``: N(0,1) noise ``[B, R, R]`` with the TPU
kernel's recipe — uniforms from 23 mantissa bits (u1 ∈ (0,1], u2 ∈ [0,1)),
full Box–Muller, the cos half in rows [0, R/2) and the sin half in
[R/2, R).  The generator is Philox4x32-10 keyed by two 32-bit words; the
counter is (call, row0 + row, 0, 0), where call c of row i yields the
normals at flat plane indices 2c, 2c+1 (cos) and R²/2 + 2c, R²/2 + 2c + 1
(sin).  Each element is a pure function of (key, row0 + row, index):
``row0`` places a batch's rows in a larger one (a rank's block of a global
batch draws what those rows of the global batch draw), and a window of plane
rows ``[h0, h0 + rows)`` (a rank's slab of an H-sharded plane) draws those
rows of the whole plane.

The streams differ from JAX's by design (so did the TPU kernel's, see
``shgan_tpu/ops/noise.py:17-20``): parity runs use ``noise_mode='const'``.

:func:`philox_normal_plain` is the same arithmetic in PyTorch integer ops.
A 32×32→64-bit product overflows ``int64``, so ``_mulhilo`` splits the
operands into 16-bit limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.rng import derive_seed
from ..kernels import build as _kb

NOISE_SALT = 0x401E  # epoch slot of derive_seed for the noise keys

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_TWO_PI = float(np.float32(2.0 * np.pi))  # 2π rounded to float32


def noise_key(seed, layer):
    """The two Philox key words of noise layer ``layer`` under ``seed``."""
    return (derive_seed(seed, layer, NOISE_SALT),
            derive_seed(seed, layer, NOISE_SALT + 1))


def noise_table(seed, layer_ids, row0=0, out=None):
    """The noise table of a model's noise layers under ``seed``: int64
    ``[max(layer_ids) + 1, 3]`` whose row ``layer_id`` is ``(*noise_key(
    seed, layer_id), row0)`` for each id in ``layer_ids`` (the other rows
    0).  A layer's random noise reads its row in place of an integer seed
    and ``row0`` (``models/layers.SynthesisLayer``), and the fused
    epilogue reads it from device memory, so a captured CUDA graph draws
    each batch's noise from the table written before its replay.  ``out``:
    a CPU int64 tensor of that shape to fill in place (a pinned staging
    buffer); returns the table."""
    ids = sorted({int(i) for i in layer_ids})
    if not ids or ids[0] < 0:
        raise ValueError(f"noise layer ids {layer_ids}")
    if row0 < 0 or row0 > _U32:
        raise ValueError(f"noise row {row0} leaves the 32-bit counter")
    rows = np.zeros((ids[-1] + 1, 3), np.int64)
    for i in ids:
        rows[i] = (*noise_key(seed, i), row0)
    if out is None:
        return torch.from_numpy(rows)
    if out.shape != rows.shape or out.dtype != torch.int64 or out.is_cuda:
        raise ValueError(f"noise table: out must be a CPU int64 "
                         f"{rows.shape}, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")
    out.numpy()[...] = rows
    return out


def _mulhilo(a, b):
    """(hi, lo) 32-bit words of the constant ``a`` times the int64 tensor
    ``b`` (values in [0, 2^32)), in 16-bit limbs so nothing overflows."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    p0, p1, p2, p3 = al * bl, al * bh, ah * bl, ah * bh
    mid = (p0 >> 16) + (p1 & 0xFFFF) + (p2 & 0xFFFF)
    lo = (p0 & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)) & _U32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 counter words; the
    key words are Python ints.  Returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _bits_to_unit(b):
    """bitcast(0x3F800000 | b >> 9) ∈ [1, 2) as float32."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def box_muller(b1, b2):
    """(cos, sin) normals from two uint32 words (int64 tensors)."""
    u1 = 2.0 - _bits_to_unit(b1)
    u2 = _bits_to_unit(b2) - 1.0
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _check_rows(row0, batch):
    if row0 < 0 or row0 + batch > _U32 + 1:
        raise ValueError(f"noise rows {row0}..{row0 + batch} leave the "
                         "32-bit counter")


def noise_window(res, h0=0, rows=None):
    """The plane-row window ``[h0, h0 + rows)`` of an ``res x res`` plane
    (``csrc/philox.cuh``: ``noise_window``): ``(base, half, (cos_lo,
    cos_hi), (sin_lo, sin_hi), (q0, q1))`` -- the window's first flat
    index, ``res * res / 2``, the pairs whose cos / sin normal it holds and
    the Philox calls that cover them."""
    rows = res if rows is None else rows
    if res < 2 or res % 2 or h0 < 0 or rows < 1 or h0 + rows > res:
        raise ValueError(f"noise window rows {h0}..{h0 + rows} of a "
                         f"{res}x{res} plane (res even)")
    half, base = res * res // 2, h0 * res
    end = base + rows * res
    cos = (min(base, half), min(end, half))
    sin = (max(base, half) - half, max(end - half, max(base, half) - half))
    spans = [r for r in (cos, sin) if r[1] > r[0]]
    lo, hi = min(r[0] for r in spans), max(r[1] for r in spans)
    return base, half, cos, sin, (lo // 2, (hi + 1) // 2)


def philox_normal_plain(key, batch, res, device="cpu", row0=0, h0=0,
                        rows=None):
    """Plain PyTorch version of kernel K1: float32 ``[batch, rows, res]``,
    rows ``[h0, h0 + rows)`` of each ``res x res`` plane (default: the
    whole plane), counter rows ``row0 ... row0 + batch - 1``."""
    _check_rows(row0, batch)
    base, half, cos, sin, (q0, q1) = noise_window(res, h0, rows)
    rows = res if rows is None else rows
    whole = rows == res
    # a window draws its calls in runs of 64 so each call's float ops run
    # in the same vector lanes as in the whole plane's draw (the CPU's
    # vectorized log/sin/cos round as its scalar tail may not)
    q1p = q1 if whole else q0 + -(-(q1 - q0) // 64) * 64
    calls = q1p - q0
    dev = torch.device(device)
    call = torch.arange(q0, q1p, dtype=torch.int64, device=dev)
    row = torch.arange(row0, row0 + batch, dtype=torch.int64, device=dev)
    c0 = call[None].expand(batch, calls)
    c1 = row[:, None].expand(batch, calls)
    zero = torch.zeros_like(c0)
    o0, o1, o2, o3 = philox4x32_10(c0, c1, zero, zero, int(key[0]) & _U32,
                                   int(key[1]) & _U32)
    cos0, sin0 = box_muller(o0, o1)
    cos1, sin1 = box_muller(o2, o3)
    cosn = torch.stack([cos0, cos1], dim=-1).reshape(batch, 2 * calls)
    sinn = torch.stack([sin0, sin1], dim=-1).reshape(batch, 2 * calls)
    if whole:
        return torch.cat([cosn, sinn], dim=1).reshape(batch, res, res)
    out = torch.empty((batch, rows * res), dtype=torch.float32, device=dev)
    for (lo, hi), normals, at in ((cos, cosn, 0), (sin, sinn, half)):
        if hi > lo:
            out[:, at + lo - base:at + hi - base] = \
                normals[:, lo - 2 * q0:hi - 2 * q0]
    return out.reshape(batch, rows, res)


def philox_normal_cuda(key, batch, res, device, row0=0, h0=0, rows=None):
    """Launch kernel K1 (``csrc/noise.cu``) on a CUDA device: rows ``[h0,
    h0 + rows)`` of each plane (default the whole plane)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("philox_normal_cuda needs a CUDA device")
    _check_rows(row0, batch)
    noise_window(res, h0, rows)
    rows = res if rows is None else rows
    out = torch.empty((batch, rows, res), dtype=torch.float32, device=dev)
    rc = _kb.launch(_kb.library("noise").shgan_philox_normal, dev,
                    out.data_ptr(), batch, res, rows, h0, int(row0),
                    int(key[0]) & _U32, int(key[1]) & _U32)
    _kb.check(rc, "philox_normal kernel")
    _kb.count("philox_normal")
    return out


def philox_normal(key, batch, res, device, row0=0, h0=0, rows=None):
    """N(0,1) ``[batch, rows, res]`` (rows ``[h0, h0 + rows)`` of each
    ``res x res`` plane, default all of them) of counter rows
    ``row0...``: kernel K1 on a CUDA device, the plain version on the
    CPU."""
    if res < 2 or res % 2:
        raise ValueError(f"noise resolution must be even, got {res}")
    kind = torch.device(device).type
    if kind == "cuda":
        return philox_normal_cuda(key, batch, res, device, row0, h0, rows)
    if kind != "cpu":
        raise ValueError(f"noise runs on CUDA or the CPU, not {device}")
    return philox_normal_plain(key, batch, res, device, row0, h0, rows)


def random_noise(seed, layer, batch, res, device, row0=0, h0=0, rows=None):
    """N(0,1) noise ``[batch, 1, rows, res]`` for synthesis layer ``layer``,
    keyed by (``seed``, ``layer``), counter rows ``row0...``, plane rows
    ``[h0, h0 + rows)`` (default the whole plane)."""
    return philox_normal(noise_key(seed, layer), batch, res, device,
                         row0, h0, rows)[:, None]
