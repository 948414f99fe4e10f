"""Formatters: element dict → (real CHW, mask HW {0=hole,1=keep}, uid) (port
of ``shgan_tpu/data/formatters.py``): CoModGAN freeform masks
(``RandomMaskFormatter``, ``FreeFormMaskFormatter``), LaMa masks
(``LamaMaskFormatter``, needs OpenCV), the scale-and-crop training
augmentation (``AdvInpaintingFormatter``), a center hole, masks from files
(``FixedMaskFormatter``) and no hole (``NoMaskFormatter``).

``real`` is float32 in [-1, 1], or uint8 0..255 when the element carries an
``image_u8`` and the formatter passes it through (normalized later, on the
device).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from .masks import lama_generator, random_mask
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


@register_formatter("LamaMaskFormatter")
class LamaMaskFormatter:
    """LaMa masks (``type`` thin / medium / thick at ``resolution`` 256 or
    512), inverted to 1 = keep."""

    def __init__(self, random_flip=True, resolution=256, type="thin"):
        self.mask_maker = lama_generator(type, resolution)
        self.random_flip = random_flip

    def __call__(self, element):
        x = element["image"] * 2 - 1
        if self.random_flip and _R.rand() < 0.5:
            x = x[:, :, ::-1].copy()
        mask = 1 - self.mask_maker(x)[0]
        return x, mask.astype(np.float32), element["unique_id"]


@register_formatter("FreeFormMaskFormatter")
class FreeFormMaskFormatter(RandomMaskFormatter):
    """The freeform masks of ``RandomMaskFormatter`` under the argument name
    ``resolution``.  Where the element carries ``content_size`` (the
    openimages pad-to-square reader), the pad is kept (mask 1), so it is
    never inpainted."""

    def __init__(self, random_flip=True, resolution=512, hole_range=(0, 1),
                 impl="auto"):
        super().__init__(random_flip=random_flip, mask_resolution=resolution,
                         hole_range=hole_range, impl=impl)

    def __call__(self, element):
        x, mask, uid = super().__call__(element)
        cs = element.get("content_size") if isinstance(element, dict) \
            else None
        if cs is not None:
            im_h, im_w = cs
            mask = np.asarray(mask)
            mask[:, im_w:] = 1.0
            mask[im_h:, :] = 1.0
        return x, mask, uid


@register_formatter("AdvInpaintingFormatter")
class AdvInpaintingFormatter:
    """A random bicubic scale (to at least ``resolution`` and at least 1.2×
    it where the image is smaller), a random crop to ``resolution`` and a
    freeform mask: the Places2 training formatter."""

    # the formatter changes the pixels: a path that serves the dataset's
    # raw rows in place of the formatter's output must refuse it
    alters_pixels = True

    def __init__(self, resolution=512, hole_range=(0, 1), impl="auto"):
        self.resolution = resolution
        self._mask = RandomMaskFormatter(random_flip=False,
                                         mask_resolution=resolution,
                                         hole_range=hole_range, impl=impl)

    def __call__(self, element):
        from .transforms import resize_bicubic_float
        x = element["image"]                       # CHW in [0, 1]
        _, oh, ow = x.shape
        s = self.resolution
        nh = _R.randint(s, max(oh, int(s * 1.2)) + 1)
        nw = _R.randint(s, max(ow, int(s * 1.2)) + 1)
        ch = _R.randint(0, nh - s + 1)
        cw = _R.randint(0, nw - s + 1)
        # the reference's order: to [-1, 1] first, then the float bicubic
        # (overshoot kept, no uint8 rounding), then the crop
        x = (x - 0.5) * 2
        x = resize_bicubic_float(x, nh, nw)
        x = x[:, ch:ch + s, cw:cw + s]
        _, mask, _ = self._mask({"image": (x + 1) / 2,
                                 "unique_id": element["unique_id"]})
        return x.astype(np.float32), mask, element["unique_id"]


@register_formatter("CenterMaskFormatter")
class CenterMaskFormatter:
    """A center-square hole of half the side."""

    def __call__(self, element):
        x = (element["image"] - 0.5) * 2
        _, h, w = x.shape
        mask = np.ones([h, w], np.float32)
        mask[h // 4: h // 4 + h // 2, w // 4: w // 4 + w // 2] = 0
        return x, mask, element["unique_id"]


@register_formatter("FixedMaskFormatter")
class FixedMaskFormatter:
    """Masks from ``<mask_dir>/<uid><suffix>`` files, keep where the grey
    value is above 128."""

    def __init__(self, mask_dir, suffix="_mask.png"):
        self.mask_dir = mask_dir
        self.suffix = suffix

    def __call__(self, element):
        from PIL import Image
        x = element["image"] * 2 - 1
        p = osp.join(self.mask_dir, element["unique_id"] + self.suffix)
        # a threshold, as the reference: PIL's convert("1") would dither
        # anti-aliased edges into speckle
        with Image.open(p) as im:
            m = (np.asarray(im.convert("L")) > 128).astype(np.float32)
        return x, m, element["unique_id"]


@register_formatter("NoMaskFormatter")
class NoMaskFormatter:
    """All-keep mask."""

    def __call__(self, element):
        x = element["image"] * 2 - 1
        _, h, w = x.shape
        return x, np.ones([h, w], np.float32), element["unique_id"]
