"""Element-transform registry: composable element → element stages in front
of a formatter, configured as ``dataset: {transforms: [{type, args}, ...]}``
(port of ``shgan_tpu/data/transforms.py``), and the float bicubic resize
of the ``AdvInpaintingFormatter``.
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


def _cubic_taps(in_size, out_size):
    """4-tap cubic-convolution gather indices and weights with
    ``F.interpolate(mode='bicubic')``'s rules: A = -0.75, the
    align_corners=False source map, border clamp."""
    A = -0.75
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base

    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1, (A + 2) * x ** 3 - (A + 3) * x ** 2 + 1,
            np.where(x < 2,
                     A * x ** 3 - 5 * A * x ** 2 + 8 * A * x - 4 * A, 0.0))

    w = np.stack([k(t + 1), k(t), k(1 - t), k(2 - t)])          # [4, out]
    idx = np.clip(np.stack([base - 1, base, base + 1, base + 2]),
                  0, in_size - 1)                               # [4, out]
    return idx, w.astype(np.float64)


def resize_bicubic_float(x_chw, out_h, out_w):
    """Float bicubic resize of a CHW array with the results of
    ``F.interpolate(mode='bicubic', align_corners=False)`` (no antialias,
    no clamp), on the host in float64, returned as float32.  A uint8 PIL
    round trip would quantize and use PIL's kernel (A = -0.5)."""
    x = np.asarray(x_chw, np.float64)
    ih, iw = x.shape[1], x.shape[2]
    idx_h, w_h = _cubic_taps(ih, out_h)
    idx_w, w_w = _cubic_taps(iw, out_w)
    xh = sum(x[:, idx_h[k], :] * w_h[k][None, :, None] for k in range(4))
    out = sum(xh[:, :, idx_w[k]] * w_w[k][None, None, :] for k in range(4))
    return out.astype(np.float32)


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
