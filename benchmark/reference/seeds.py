"""What the served program derives from its seed, worked out again: the
per-position latents, the per-batch noise seed, each noise layer's Philox
key and the Philox4x32-10 + Box-Muller normals of a synthesis layer's noise.

Frozen copies of the published recipe (the SplitMix-style seed mix, the
salts, the counter layout of the noise stream), in plain numpy and PyTorch.
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

_M64 = (1 << 64) - 1
_U32 = 0xFFFFFFFF
Z_SALT = 0x5EED            # the latent of dataset position i
BATCH_NOISE_SALT = 0xB47C  # the noise seed of a batch starting at position s
NOISE_SALT = 0x401E        # the two key words of noise layer l: salt, salt + 1
TRAIN_SALT = 0x7A11        # the random draws of training step k

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = float(np.float32(2.0 * np.pi))


def derive_seed(seed, index, salt=0):
    """A 31-bit seed from (seed, salt, index), SplitMix-style."""
    x = (seed * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) & _M64
    x = ((x ^ (x >> 31)) * 0xD6E8FEB86659FD93) & _M64
    return (x ^ (x >> 27)) & 0x7FFFFFFF


def latents(seed, z_dim, positions):
    """z of each dataset position: N(0, 1) float32 from its own
    ``np.random.RandomState``."""
    return np.stack([
        np.random.RandomState(derive_seed(seed, int(i), Z_SALT))
        .randn(z_dim).astype(np.float32) for i in positions])


def batch_noise_seed(seed, start):
    return derive_seed(seed, start, BATCH_NOISE_SALT)


def noise_key(seed, layer):
    return (derive_seed(seed, layer, NOISE_SALT),
            derive_seed(seed, layer, NOISE_SALT + 1))


def _mulhilo(a, b):
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    p0, p1, p2, p3 = al * bl, al * bh, ah * bl, ah * bh
    mid = (p0 >> 16) + (p1 & 0xFFFF) + (p2 & 0xFFFF)
    lo = (p0 & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)) & _U32
    return hi, lo


def _philox(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit(b):
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def _box_muller(b1, b2):
    u1 = 2.0 - _unit(b1)
    u2 = _unit(b2) - 1.0
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2), r * torch.sin(_TWO_PI * u2)


def layer_noise(key, batch, res, device, row0=0):
    """N(0, 1) [batch, 1, res, res] of one noise layer: call c of counter
    row i gives the normals at flat indices 2c, 2c + 1 (cosines, the first
    half of the plane) and res²/2 + 2c, res²/2 + 2c + 1 (sines)."""
    calls = res * res // 4
    call = torch.arange(calls, dtype=torch.int64, device=device)
    row = torch.arange(row0, row0 + batch, dtype=torch.int64, device=device)
    c0 = call[None].expand(batch, calls)
    c1 = row[:, None].expand(batch, calls)
    zero = torch.zeros_like(c0)
    o0, o1, o2, o3 = _philox(c0, c1, zero, zero, int(key[0]) & _U32,
                             int(key[1]) & _U32)
    cos0, sin0 = _box_muller(o0, o1)
    cos1, sin1 = _box_muller(o2, o3)
    cos = torch.stack([cos0, cos1], dim=-1).reshape(batch, 2 * calls)
    sin = torch.stack([sin0, sin1], dim=-1).reshape(batch, 2 * calls)
    return torch.cat([cos, sin], dim=1).reshape(batch, 1, res, res)
