"""Thread-local RNG for the host data path (copy of ``shgan_tpu/data/rng.py``).

``R`` is an ``np.random``-compatible proxy: inside a :func:`batch_rng` scope
it delegates to a thread-local ``RandomState`` (the pipeline seeds one per
sample from (pipeline seed, global position)), so samples are the same for
any worker count or thread scheduling; outside any scope it falls through to
the global ``np.random``.  ``derive_seed`` is kept bit-identical, so both
packages draw the same masks, latents and per-batch noise seeds.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np

_TLS = threading.local()


class _RNGProxy:
    __slots__ = ()

    @staticmethod
    def _rng():
        return getattr(_TLS, "rng", None) or np.random

    def __getattr__(self, name):
        return getattr(self._rng(), name)


R = _RNGProxy()

_M64 = (1 << 64) - 1


def derive_seed(seed, batch_idx, epoch=0):
    """Deterministic per-batch seed (SplitMix-style mix so nearby
    (seed, epoch, batch) tuples land far apart); a 31-bit int."""
    x = (seed * 0x9E3779B97F4A7C15
         + epoch * 0xBF58476D1CE4E5B9
         + batch_idx * 0x94D049BB133111EB) & _M64
    x = ((x ^ (x >> 31)) * 0xD6E8FEB86659FD93) & _M64
    return (x ^ (x >> 27)) & 0x7FFFFFFF


@contextmanager
def batch_rng(seed):
    """Scope with a fresh thread-local RandomState(seed); ``None`` → the
    global ``np.random``."""
    old = getattr(_TLS, "rng", None)
    _TLS.rng = np.random.RandomState(seed) if seed is not None else None
    try:
        yield
    finally:
        _TLS.rng = old
