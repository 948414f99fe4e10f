"""Small shared helpers (port of ``shgan_tpu/utils/misc.py``)."""

from __future__ import annotations

import functools


def assert_shape(x, ref_shape):
    """Shape assert with ``None`` wildcards."""
    if x.ndim != len(ref_shape):
        raise AssertionError(
            f"Wrong number of dimensions: got {x.ndim}, "
            f"expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(x.shape, ref_shape)):
        if ref_size is None:
            continue
        if int(size) != int(ref_size):
            raise AssertionError(
                f"Wrong size for dimension {idx}: got {size}, "
                f"expected {ref_size}")


def constant_cache(fn):
    """Memoize constants by their hashable args."""
    return functools.lru_cache(maxsize=None)(fn)
