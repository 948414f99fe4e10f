"""Deterministic seed derivation (copy of ``shgan_tpu/data/rng.py:45-52``).

Kept bit-identical so both packages draw the same per-position latents
(``models/infer.py::z_for_positions``).
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


def derive_seed(seed, batch_idx, epoch=0):
    """Deterministic per-batch seed (SplitMix-style mix so nearby
    (seed, epoch, batch) tuples land far apart); a 31-bit int."""
    x = (seed * 0x9E3779B97F4A7C15
         + epoch * 0xBF58476D1CE4E5B9
         + batch_idx * 0x94D049BB133111EB) & _M64
    x = ((x ^ (x >> 31)) * 0xD6E8FEB86659FD93) & _M64
    return (x ^ (x >> 27)) & 0x7FFFFFFF
