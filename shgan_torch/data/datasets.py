"""Datasets: index builders + image loaders, host-side (port of
``shgan_tpu/data/datasets.py``).

Readers: ``ffhqzip`` (the FFHQ zips, split by sorted uid: val = [0, 10000),
train = [10000, 70000)), ``places2`` (a directory walk with a bicubic
resize), ``ffhq`` (the json index), ``ffhqsimple``, ``openimages``
(pad-to-square with ``content_size``), ``texture``, ``imagedir`` and
``synthetic``; ``loadgen`` and its ``ffhqzip_loadgen`` / ``places2_loadgen``
forms pair a reader's reals with pre-generated images (``--evalnog_path``).

A dataset yields element dicts ({'image': float32 CHW in [0, 1],
'unique_id': str}, plus 'image_u8' where the dataset carries uint8, 'gen'
for a loadgen pair, 'content_size' for openimages); a formatter
(:mod:`.formatters`) turns an element into (real, mask, uid).
"""

from __future__ import annotations

import io
import os
import os.path as osp
import sys
import threading
import zipfile

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
    a :class:`SyntheticDataset` at the configured resolution instead, still
    paired with ``gen_dir`` where one is set."""
    if isinstance(cfg, str):
        return _DATASET_REGISTRY[cfg]()
    typ = cfg["type"]
    if typ not in _DATASET_REGISTRY:
        raise KeyError(f"unknown dataset type {typ!r}; the registry has "
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
        ds = SyntheticDataset(resolution=res, length=64,
                              try_sample=args.get("try_sample"))
        gen_dir = args.get("gen_dir") or cfg.get("gen_dir")
        if gen_dir:
            # a debug --evalnog_path run still takes the pre-generated path
            ds = LoadGenDataset(ds, gen_dir)
        return ds
    if pick and hasattr(ds, "load_info"):   # not on a loadgen pair
        keep = set(pick)
        ds.load_info = [i for i in ds.load_info
                        if i["unique_id"] in keep] * pick_repeat
    if pick_index and hasattr(ds, "load_info"):
        ds.load_info = [ds.load_info[i] for i in pick_index]
    return CachedDataset(ds) if cache else ds


def _decode_png(data):
    """PNG bytes → HWC uint8 (pyspng where it imports, else PIL; both give
    the same bytes)."""
    try:
        import pyspng
        return pyspng.load(data)
    except ImportError:
        from PIL import Image
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))


def _load_rgb(path, resolution=None):
    """An image file as a PIL RGB image, bicubic-resized to a square
    ``resolution`` where one is given and the size differs."""
    from PIL import Image
    with Image.open(path) as im:
        img = im.convert("RGB")
    if resolution and img.size != (resolution, resolution):
        img = img.resize((resolution, resolution), Image.BICUBIC)
    return img


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


@register_dataset("ffhqzip")
class FFHQZipDataset(_Base):
    """FFHQ from ``ffhq{256x256,512x512}.zip``; ``mode`` picks the zip and
    the ``[lo, hi)`` range of the uids in sorted order."""

    SPLITS = {
        "train256": ("ffhq256x256.zip", (10000, 70000)),
        "val256": ("ffhq256x256.zip", (0, 10000)),
        "train512": ("ffhq512x512.zip", (10000, 70000)),
        "val512": ("ffhq512x512.zip", (0, 10000)),
        "train512ori": ("ffhq512x512.zip", (10000, 70000)),
        "val512ori": ("ffhq512x512.zip", (0, 10000)),
    }

    def __init__(self, root_dir, mode="val256", try_sample=None):
        zipname, (lo, hi) = self.SPLITS[mode]
        self.zip_path = osp.join(root_dir, zipname)
        info = []
        with zipfile.ZipFile(self.zip_path) as z:
            for fi in z.namelist():
                if ".png" not in fi:
                    continue
                uid = osp.splitext(osp.basename(fi))[0]
                info.append({"unique_id": uid, "image_path": fi})
        info = sorted(info, key=lambda x: x["unique_id"])[lo:hi]
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info
        self._tls = threading.local()

    def _zip(self):
        # one handle per thread: ZipFile serializes reads of a shared
        # handle on a lock, which would serialize the decode workers
        tls = self._tls
        if getattr(tls, "zf", None) is None or tls.pid != os.getpid():
            tls.zf = zipfile.ZipFile(self.zip_path)
            tls.pid = os.getpid()
        return tls.zf

    def __getitem__(self, i):
        info = self.load_info[i]
        data = self._zip().read(info["image_path"])
        return {"image": _to_chw01(_decode_png(data)),
                "unique_id": info["unique_id"]}


def _walk_images(base, exts):
    """(uid, path) of every file under ``base`` with an extension in
    ``exts``, the uid its relative path without extension, '/' → '_'."""
    out = []
    for dirpath, _d, filenames in sorted(os.walk(base)):
        for fn in sorted(filenames):
            if osp.splitext(fn)[1].lower() not in exts:
                continue
            path = osp.join(dirpath, fn)
            uid = osp.splitext(osp.relpath(path, base))[0].replace("/", "_")
            out.append({"unique_id": uid, "image_path": path})
    return out


@register_dataset("places2")
class Places2Dataset(_Base):
    """Places2 by directory walk (``mode`` → the subdirectory), bicubic
    resize to ``resolution``."""

    MODES = {
        "train": "data_challenge",
        "train_large": "data_large",
        "val": "val_large",
        "val_large": "val_large",
        "test": "test_large",
    }

    def __init__(self, root_dir, mode="val_large", resolution=256,
                 try_sample=None):
        base = osp.join(root_dir, self.MODES.get(mode, mode))
        if not osp.isdir(base):
            raise FileNotFoundError(f"places2 root not found: {base}")
        info = sorted(_walk_images(base, (".jpg", ".jpeg", ".png")),
                      key=lambda x: x["unique_id"])
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info
        self.resolution = resolution

    def __getitem__(self, i):
        info = self.load_info[i]
        img = _load_rgb(info["image_path"], self.resolution)
        return {"image": _to_chw01(np.asarray(img)),
                "unique_id": info["unique_id"]}


@register_dataset("imagedir")
class ImageDirDataset(_Base):
    """Flat or recursive image directory."""

    def __init__(self, root_dir, resolution=None, try_sample=None):
        if not osp.isdir(root_dir):
            raise FileNotFoundError(f"image dir not found: {root_dir}")
        info = _walk_images(root_dir, (".jpg", ".jpeg", ".png", ".webp"))
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info
        self.resolution = resolution

    def __getitem__(self, i):
        info = self.load_info[i]
        img = _load_rgb(info["image_path"], self.resolution)
        return {"image": _to_chw01(np.asarray(img)),
                "unique_id": info["unique_id"]}


@register_dataset("ffhq")
class FFHQJsonDataset(_Base):
    """FFHQ through the official ``ffhq-dataset-v2.json`` index: ``mode``
    is a '+'-joined subset of train/val (the json ``category``); uids are
    '00_train-<stem>' / '50_val-<stem>'.  ``allow_partial`` skips missing
    files, else a missing file raises; ``resolution`` adds a bicubic
    resize."""

    _CATEGORY = {"train": "training", "val": "validation"}
    _MODETAG = {"training": "00_train", "validation": "50_val"}

    def __init__(self, root_dir, mode="train", allow_partial=False,
                 resolution=None, try_sample=None):
        import json
        index = osp.join(root_dir, "ffhq-dataset-v2.json")
        if not osp.isfile(index):
            raise FileNotFoundError(index)
        with open(index) as f:
            jinfo = json.load(f)
        subset = {self._CATEGORY.get(m) for m in str(mode).split("+")}
        info = []
        for ji in jinfo.values():
            if ji["category"] not in subset:
                continue
            impath = osp.join(root_dir, ji["image"]["file_path"])
            if not impath.endswith((".jpg", ".png")):
                continue
            if not osp.isfile(impath):
                if allow_partial:
                    continue
                raise ValueError(f"missing image {impath}")
            stem = osp.splitext(osp.basename(impath))[0]
            info.append({"unique_id": f"{self._MODETAG[ji['category']]}-"
                                      f"{stem}",
                         "image_path": impath})
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info
        self.resolution = resolution

    def __getitem__(self, i):
        info = self.load_info[i]
        img = _load_rgb(info["image_path"], self.resolution)
        return {"image": _to_chw01(np.asarray(img)),
                "unique_id": info["unique_id"]}


@register_dataset("ffhqsimple")
class FFHQSimpleDataset(_Base):
    """FFHQ from the extracted ``ffhq256x256/<sub>/<id>.png`` tree (mode
    train256 only)."""

    def __init__(self, root_dir, mode="train256", try_sample=None):
        if mode != "train256":
            raise ValueError(f"ffhqsimple supports mode train256, got "
                             f"{mode!r}")
        base = osp.join(root_dir, "ffhq256x256")
        if not osp.isdir(base):
            raise FileNotFoundError(base)
        info = []
        for sub in sorted(os.listdir(base)):
            subdir = osp.join(base, sub)
            if not osp.isdir(subdir):
                continue
            for fn in sorted(os.listdir(subdir)):
                if fn.endswith(".png"):
                    info.append({"unique_id": osp.splitext(fn)[0],
                                 "image_path": osp.join(subdir, fn)})
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info

    def __getitem__(self, i):
        info = self.load_info[i]
        return {"image": _to_chw01(np.asarray(_load_rgb(info["image_path"]))),
                "unique_id": info["unique_id"]}


def _fit_resolution(img, resolution):
    """Aspect-preserving bicubic downscale so the long side fits, zero-pad
    to a square, and the content size (h, w) before the pad (the
    FreeFormMaskFormatter keeps the pad)."""
    from PIL import Image
    w, h = img.size
    if w > resolution or h > resolution:
        ratio = resolution / w if w > h else resolution / h
        target = ((resolution, int(h * ratio)) if w > h
                  else (int(w * ratio), resolution))
        img = img.resize(target, Image.BICUBIC)
    content_size = (img.size[1], img.size[0])
    padded = np.zeros((resolution, resolution, 3), np.uint8)
    arr = np.asarray(img, np.uint8)
    padded[: arr.shape[0], : arr.shape[1]] = arr
    return padded, content_size


@register_dataset("openimages")
class OpenImagesDataset(_Base):
    """OpenImagesV6: mode train → <root>/train, val → <root>/validation;
    the uid joins the subdirectories and the file stem with '-'.  Images
    are fitted into a padded square with ``content_size`` recorded."""

    MODES = {"train": "train", "val": "validation"}

    def __init__(self, root_dir, mode="val", resolution=512,
                 try_sample=None):
        if mode not in self.MODES:
            raise ValueError(f"openimages mode must be train|val, got "
                             f"{mode!r}")
        base = osp.join(root_dir, self.MODES[mode])
        if not osp.isdir(base):
            raise FileNotFoundError(base)
        info = []
        for dirpath, _d, filenames in sorted(os.walk(base)):
            for fn in sorted(filenames):
                path = osp.join(dirpath, fn)
                if not path.endswith((".jpg", ".png")):
                    continue
                rel = osp.relpath(dirpath, base)
                tags = (([] if rel == "." else rel.split(os.sep))
                        + [osp.splitext(fn)[0]])
                info.append({"unique_id": "-".join(tags),
                             "image_path": path})
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info
        self.resolution = resolution

    def __getitem__(self, i):
        info = self.load_info[i]
        padded, content_size = _fit_resolution(
            _load_rgb(info["image_path"]), self.resolution)
        return {"image": _to_chw01(padded), "content_size": content_size,
                "unique_id": info["unique_id"]}


@register_dataset("texture")
class TextureDataset(_Base):
    """DTD textures: file lists from ``<root>/dtd/labels/<mode>.txt``
    ('+'-joinable), images at ``<root>/dtd/images/<type>/<file>``, square
    bicubic resize.  ``mixed_order_on_texture_type`` round-robins the
    texture types and prefixes each uid with a running count."""

    def __init__(self, root_dir, mode="train1", resolution=512,
                 mixed_order_on_texture_type=False, try_sample=None):
        labels = osp.join(root_dir, "dtd", "labels")
        if not osp.isdir(labels):
            raise FileNotFoundError(labels)
        imlist = []
        for m in str(mode).split("+"):
            if not m.startswith(("train", "val", "test")):
                raise ValueError(f"texture mode part {m!r}")
            with open(osp.join(labels, m + ".txt")) as f:
                imlist += [li.strip() for li in f if li.strip()]
        info = []
        for imref in imlist:
            ttype, filename = osp.split(imref)
            info.append({
                "unique_id": osp.splitext(filename)[0],
                "texture_type": ttype,
                "image_path": osp.join(root_dir, "dtd", "images", ttype,
                                       filename)})
        if mixed_order_on_texture_type:
            groups = {}
            for el in info:
                groups.setdefault(el["texture_type"], []).append(el)
            info, cnt = [], 0
            while groups:
                for tt in list(groups):
                    if not groups[tt]:
                        groups.pop(tt)
                        continue
                    el = dict(groups[tt].pop(0))
                    el["unique_id"] = "{:05d}_".format(cnt) + el["unique_id"]
                    info.append(el)
                    cnt += 1
        if try_sample is not None:
            info = info[:try_sample]
        self.load_info = info
        self.resolution = resolution

    def __getitem__(self, i):
        info = self.load_info[i]
        img = _load_rgb(info["image_path"], self.resolution)
        return {"image": _to_chw01(np.asarray(img)),
                "unique_id": info["unique_id"]}


@register_dataset("loadgen")
class LoadGenDataset(_Base):
    """A base dataset's reals paired with pre-generated images from
    ``gen_dir`` (``<uid>.png|.jpg|.jpeg``) as the element's ``gen``: eval
    without the generator (``--evalnog_path``)."""

    def __init__(self, base, gen_dir, exts=(".png", ".jpg", ".jpeg")):
        self.base = get_dataset(base) if isinstance(base, dict) else base
        self.gen_dir = gen_dir
        self.exts = exts

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        el = self.base[i]
        uid = el["unique_id"]
        for ext in self.exts:
            p = osp.join(self.gen_dir, uid + ext)
            if osp.isfile(p):
                break
        else:
            raise FileNotFoundError(
                f"no generated image for {uid!r} in {self.gen_dir}")
        el["gen"] = _to_chw01(np.asarray(_load_rgb(p)))
        return el


@register_dataset("ffhqzip_loadgen")
class FFHQZipLoadGen(LoadGenDataset):
    def __init__(self, root_dir, gen_dir, mode="val256", try_sample=None):
        super().__init__(FFHQZipDataset(root_dir, mode, try_sample), gen_dir)


@register_dataset("places2_loadgen")
class Places2LoadGen(LoadGenDataset):
    def __init__(self, root_dir, gen_dir, mode="val", resolution=256,
                 try_sample=None):
        super().__init__(
            Places2Dataset(root_dir, mode=mode, resolution=resolution,
                           try_sample=try_sample), gen_dir)


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
