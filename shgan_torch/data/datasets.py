"""Datasets: index builders + image loaders, host-side (port of the registry,
``get_dataset``, ``ImageDirDataset`` and ``SyntheticDataset`` of
``shgan_tpu/data/datasets.py``; the FFHQ, Places2 and OpenImages readers
come later).

A dataset yields element dicts ({'image': float32 CHW in [0, 1],
'unique_id': str}, plus 'image_u8' where the dataset carries uint8); a
formatter (:mod:`.formatters`) turns an element into (real, mask, uid).
"""

from __future__ import annotations

import os
import os.path as osp
import sys

import numpy as np

_DATASET_REGISTRY = {}


def register_dataset(name):
    def wrap(cls):
        _DATASET_REGISTRY[name] = cls
        return cls
    return wrap


_DATASET_CFG_KEYS = ("root_dir", "mode", "resolution", "try_sample",
                     "length", "seed", "allow_partial",
                     "mixed_order_on_texture_type")


def get_dataset(cfg, fallback_synthetic=False):
    """Build a dataset from a config dict: the dataset bank's top-level
    keys (``root_dir``, ``mode``, ``resolution``, ...) and/or an ``args``
    dict; ``pick`` / ``pick_index`` / ``pick_repeat`` restrict it, and
    ``cache`` memoizes its elements.

    With ``fallback_synthetic=True`` (debug runs) a missing data root gives
    a :class:`SyntheticDataset` at the configured resolution instead."""
    if isinstance(cfg, str):
        return _DATASET_REGISTRY[cfg]()
    typ = cfg["type"]
    if typ not in _DATASET_REGISTRY:
        raise NotImplementedError(
            f"dataset type {typ!r} is not in the port yet; it has "
            f"{sorted(_DATASET_REGISTRY)}")
    args = dict(cfg.get("args") or {})
    for k in _DATASET_CFG_KEYS:
        if cfg.get(k) is not None and k not in args:
            args[k] = cfg[k]
    cache = bool(args.pop("cache", None) or cfg.get("cache"))
    pick = args.pop("pick", None) or cfg.get("pick")
    pick_index = args.pop("pick_index", None) or cfg.get("pick_index")
    pick_repeat = int(args.pop("pick_repeat", None)
                      or cfg.get("pick_repeat") or 1)
    try:
        ds = _DATASET_REGISTRY[typ](**args)
    except FileNotFoundError:
        if not fallback_synthetic:
            raise
        res = args.get("resolution")
        if res is None:
            digits = "".join(c for c in str(args.get("mode", ""))
                             if c.isdigit())
            res = int(digits) if digits else 256
        print(f"[shgan_torch.data] data root missing for {typ!r}; using "
              f"synthetic {res}px dataset (debug fallback)", file=sys.stderr)
        return SyntheticDataset(resolution=res, length=64,
                                try_sample=args.get("try_sample"))
    if pick:
        keep = set(pick)
        ds.load_info = [i for i in ds.load_info
                        if i["unique_id"] in keep] * pick_repeat
    if pick_index:
        ds.load_info = [ds.load_info[i] for i in pick_index]
    return CachedDataset(ds) if cache else ds


def _to_chw01(img_hwc_uint8):
    img = np.asarray(img_hwc_uint8)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, 2)
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img.transpose(2, 0, 1).astype(np.float32) / 255.0


class _Base:
    """len/getitem protocol: __getitem__ returns an element dict."""

    load_info: list

    def __len__(self):
        return len(self.load_info)


class CachedDataset(_Base):
    """In-memory element cache (the pipeline's workers are threads, so a
    plain dict is shared by all of them)."""

    def __init__(self, base):
        self.base = base
        self._cache = {}

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if i not in self._cache:
            self._cache[i] = self.base[i]
        return self._cache[i]


@register_dataset("imagedir")
class ImageDirDataset(_Base):
    """Flat or recursive image directory."""

    def __init__(self, root_dir, resolution=None, try_sample=None):
        if not osp.isdir(root_dir):
            raise FileNotFoundError(f"image dir not found: {root_dir}")
        info = []
        for dirpath, _d, filenames in sorted(os.walk(root_dir)):
            for fn in sorted(filenames):
                if osp.splitext(fn)[1].lower() not in (".jpg", ".jpeg",
                                                       ".png", ".webp"):
                    continue
                path = osp.join(dirpath, fn)
                uid = osp.splitext(osp.relpath(path, root_dir))[0].replace(
                    "/", "_")
                info.append({"unique_id": uid, "image_path": path})
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info
        self.resolution = resolution

    def __getitem__(self, i):
        from PIL import Image
        info = self.load_info[i]
        with Image.open(info["image_path"]) as im:
            img = im.convert("RGB")
        if self.resolution and img.size != (self.resolution,
                                            self.resolution):
            img = img.resize((self.resolution, self.resolution),
                             Image.BICUBIC)
        return {"image": _to_chw01(np.asarray(img)),
                "unique_id": info["unique_id"]}


@register_dataset("synthetic")
class SyntheticDataset(_Base):
    """Deterministic procedural images (no data root).

    ``pool=K`` generates only K distinct images (cached after first use)
    and serves position ``i`` the image ``i % K``; positions keep distinct
    uids, masks and latents.  ``as_u8`` adds an ``image_u8`` to every
    element, which the formatters pass through untouched."""

    def __init__(self, resolution=256, length=64, seed=0, try_sample=None,
                 pool=None, as_u8=False):
        self.resolution = resolution
        self.seed = seed
        self.pool = pool
        self.as_u8 = as_u8
        self._pool_cache = {}
        if try_sample is not None:
            length = min(length, try_sample)
        self.load_info = [{"unique_id": f"syn{i:05d}"} for i in range(length)]

    def _gen(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        res = self.resolution
        y = np.linspace(0, 1, res, dtype=np.float32)
        base = rng.rand(3, 1, 1).astype(np.float32)
        img = (base + 0.5 * np.outer(y, y)[None]
               + 0.1 * rng.randn(3, res, res).astype(np.float32))
        return np.clip(img, 0, 1)

    def __getitem__(self, i):
        if self.pool:
            j = int(i) % self.pool
            el = self._pool_cache.get(j)
            if el is None:
                # idempotent under concurrent prefetch threads
                el = self._element(j)
                self._pool_cache[j] = el
        else:
            el = self._element(i)
        return dict(el, unique_id=self.load_info[i]["unique_id"])

    def _element(self, i):
        img = self._gen(i)
        el = {"image": img}
        if self.as_u8:
            el["image_u8"] = np.rint(img * 255).clip(0, 255).astype(np.uint8)
        return el
