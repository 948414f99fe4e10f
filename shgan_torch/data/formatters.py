"""Formatters: element dict → (real CHW, mask HW {0=hole,1=keep}, uid) (port
of the registry and ``RandomMaskFormatter`` of
``shgan_tpu/data/formatters.py``; the other formatters come later).

``real`` is float32 in [-1, 1], or uint8 0..255 when the element carries an
``image_u8`` (normalized later, on the device).
"""

from __future__ import annotations

from .masks import random_mask
from .rng import R as _R

_FORMATTER_REGISTRY = {}


def register_formatter(name):
    def wrap(cls):
        _FORMATTER_REGISTRY[name] = cls
        return cls
    return wrap


def get_formatter(cfg):
    if isinstance(cfg, str):
        return _FORMATTER_REGISTRY[cfg]()
    return _FORMATTER_REGISTRY[cfg["type"]](**dict(cfg.get("args") or {}))


@register_formatter("RandomMaskFormatter")
class RandomMaskFormatter:
    """CoModGAN freeform masks — the eval protocol behind the published
    metrics.  ``impl``: "auto" uses the native C++ generator when it builds
    and the numpy masks otherwise; "native" requires it; "numpy" never
    uses it.  The two give different masks (different RNGs)."""

    def __init__(self, random_flip=True, mask_resolution=256,
                 hole_range=(0, 1), impl="auto"):
        self.random_flip = random_flip
        self.mask_resolution = mask_resolution
        self.hole_range = tuple(hole_range)
        self.impl = impl
        self._native = False
        if impl != "numpy":
            from ..native.maskgen import load_error, native_available
            self._native = native_available()
            if impl == "native" and not self._native:
                raise RuntimeError(
                    f"impl='native' requires the C++ maskgen but it is "
                    f"unavailable ({load_error()}); use impl='auto' for the "
                    "numpy fallback")

    def __call__(self, element):
        u8 = element.get("image_u8") if isinstance(element, dict) else None
        if u8 is not None:
            x = u8
            if self.random_flip and _R.rand() < 0.5:
                x = x[:, :, ::-1]
        else:
            x = element["image"] * 2 - 1
            if self.random_flip and _R.rand() < 0.5:
                x = x[:, :, ::-1].copy()
        if self._native:
            # seeded from the formatter's RNG stream, so still reproducible
            from ..native.maskgen import random_mask_batch
            seed = int(_R.randint(0, 2 ** 31 - 1))
            mask = random_mask_batch(1, self.mask_resolution,
                                     self.hole_range, seed=seed,
                                     num_threads=1)[0, 0]
        else:
            mask = random_mask(self.mask_resolution, self.hole_range)[0]
        return x, mask, element["unique_id"]
