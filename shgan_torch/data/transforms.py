"""Element-transform registry: composable element → element stages in front
of a formatter, configured as ``dataset: {transforms: [{type, args}, ...]}``
(port of ``shgan_tpu/data/transforms.py``, without the float bicubic resize
of the training formatter).
"""

from __future__ import annotations

import numpy as np

from .rng import R as _R

_TRANSFORM_REGISTRY = {}


def register_transform(name):
    def wrap(cls):
        _TRANSFORM_REGISTRY[name] = cls
        return cls
    return wrap


def get_transforms(cfg_list):
    """cfg_list: list of {'type': name, 'args': {...}} (or names) → one
    element → element callable (identity for an empty list or None)."""
    if not cfg_list:
        return lambda el: el
    ts = []
    for c in cfg_list:
        if isinstance(c, str):
            ts.append(_TRANSFORM_REGISTRY[c]())
        else:
            ts.append(_TRANSFORM_REGISTRY[c["type"]](
                **dict(c.get("args") or {})))

    def compose(el):
        for t in ts:
            before = el.get("image") if isinstance(el, dict) else None
            el = t(el)
            if (isinstance(el, dict) and "image_u8" in el
                    and el.get("image") is not before):
                # the transform rewrote the float image: a cached uint8
                # copy is stale, and the formatters prefer it
                el = dict(el)
                el.pop("image_u8")
        return el
    return compose


def wrap_formatter(formatter, transforms_cfg):
    """Compose a transforms pipeline in front of a formatter."""
    if not transforms_cfg:
        return formatter
    t = get_transforms(transforms_cfg)

    def wrapped(el):
        return formatter(t(el))
    return wrapped


def _to_pil(img_chw01):
    from PIL import Image
    return Image.fromarray(
        (np.clip(img_chw01, 0, 1).transpose(1, 2, 0) * 255)
        .astype(np.uint8))


def _from_pil(img):
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


@register_transform("Resize")
class Resize:
    """Resize to a square resolution through PIL (bicubic by default)."""

    def __init__(self, resolution, method="bicubic"):
        self.resolution = resolution
        self.method = method

    def __call__(self, el):
        from PIL import Image
        if el["image"].shape[1:] == (self.resolution, self.resolution):
            return el  # no uint8 round trip when the size is right
        img = _to_pil(el["image"])
        m = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
             "nearest": Image.NEAREST, "lanczos": Image.LANCZOS}
        img = img.resize((self.resolution, self.resolution), m[self.method])
        el = dict(el)
        el["image"] = _from_pil(img)
        return el


@register_transform("CenterCrop")
class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, el):
        x = el["image"]
        _, h, w = x.shape
        s = self.size
        top, left = (h - s) // 2, (w - s) // 2
        el = dict(el)
        el["image"] = x[:, top:top + s, left:left + s]
        return el


@register_transform("RandomFlip")
class RandomFlip:
    """Horizontal flip with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, el):
        if _R.rand() < self.p:
            el = dict(el)
            el["image"] = el["image"][:, :, ::-1].copy()
        return el


@register_transform("UniformNumpyType")
class UniformNumpyType:
    """Cast the image to a numpy dtype."""

    def __init__(self, dtype="float32"):
        self.dtype = np.dtype(dtype)

    def __call__(self, el):
        el = dict(el)
        el["image"] = np.asarray(el["image"], self.dtype)
        return el
