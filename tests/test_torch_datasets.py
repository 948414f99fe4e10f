"""The port's dataset readers against shgan_tpu's, element for element, over
zips, directory trees and json indexes built in ``tmp_path``: FFHQ's zip
(val256 and train256 splits), Places2, the json-indexed and extracted
FFHQ, OpenImages, DTD textures, the loadgen pairings and the debug
fallback that keeps them; every dataset type of ``configs/dataset``."""

import json
import os
import os.path as osp
import sys
import threading
import zipfile

import numpy as np
import pytest
from PIL import Image

from shgan_tpu.data import datasets as jds
from shgan_tpu.runtime.config import dataset_cfg_bank as j_bank
from shgan_torch.data import datasets as tds
from shgan_torch.runtime.config import dataset_cfg_bank


@pytest.fixture(autouse=True)
def real_png_decoder(monkeypatch):
    """tests/test_data.py puts a ``pyspng`` stub whose ``load`` returns None
    into ``sys.modules`` (for the reference's modules); the readers here
    must decode with the real module or with PIL."""
    mod = sys.modules.get("pyspng")
    if mod is not None and getattr(mod, "__file__", None) is None:
        monkeypatch.delitem(sys.modules, "pyspng")


def _rgb(rng, h, w):
    return rng.randint(0, 256, (h, w, 3), np.uint8)


def _save(path, arr):
    os.makedirs(osp.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _same(cfg, **kw):
    """Build ``cfg`` in both packages; every element equal, bit for bit."""
    j, t = jds.get_dataset(cfg, **kw), tds.get_dataset(cfg, **kw)
    assert len(t) == len(j)
    for i in range(len(j)):
        a, b = j[i], t[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]
    return j, t


@pytest.fixture()
def ffhq_zip(tmp_path):
    """A 256-resolution FFHQ zip of 12 PNGs in shuffled order, in
    subfolders, beside a non-PNG entry."""
    root = tmp_path / "ffhq"
    root.mkdir()
    rng = np.random.RandomState(0)
    with zipfile.ZipFile(root / "ffhq256x256.zip", "w") as z:
        z.writestr("LICENSE.txt", "not an image")
        for i in rng.permutation(12):
            buf = Image.fromarray(_rgb(rng, 16, 16))
            path = tmp_path / "tmp.png"
            buf.save(path)
            z.write(path, f"{i // 10:02d}000/{i:05d}.png")
    return str(root)


@pytest.mark.parametrize("mode", ["val256", "train256"])
def test_ffhqzip_matches_jax(ffhq_zip, mode):
    """Fewer than 10000 PNGs: all of them are val256, none train256."""
    j, t = _same({"type": "ffhqzip", "root_dir": ffhq_zip, "mode": mode})
    want = [f"{i:05d}" for i in range(12)] if mode == "val256" else []
    assert [i["unique_id"] for i in t.load_info] == want
    _same({"type": "ffhqzip", "root_dir": ffhq_zip, "mode": mode,
           "try_sample": 5})


def test_ffhqzip_opens_a_handle_per_thread(ffhq_zip):
    ds = tds.get_dataset({"type": "ffhqzip", "root_dir": ffhq_zip,
                          "mode": "val256"})
    handles = []
    th = threading.Thread(target=lambda: handles.append(ds._zip()))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    assert ds._zip() is ds._zip() and handles[0] is not ds._zip()


def test_missing_roots_raise(tmp_path):
    for cfg in ({"type": "ffhqzip", "root_dir": str(tmp_path),
                 "mode": "val256"},
                {"type": "places2", "root_dir": str(tmp_path),
                 "mode": "val_large"}):
        for get in (jds.get_dataset, tds.get_dataset):
            with pytest.raises(FileNotFoundError):
                get(cfg)


@pytest.fixture()
def places2_root(tmp_path):
    rng = np.random.RandomState(1)
    root = tmp_path / "places2"
    for name in ("val_large/b/c.jpg", "val_large/a.png", "val_large/Z.JPEG",
                 "val_large/skip.txt", "data_challenge/x/y.jpg"):
        p = root / name
        if name.endswith(".txt"):
            os.makedirs(p.parent, exist_ok=True)
            p.write_text("x")
        else:
            _save(str(p), _rgb(rng, 20, 24))
    return str(root)


@pytest.mark.parametrize("mode,res", [("val", 16), ("val_large", 24),
                                      ("train", 8)])
def test_places2_matches_jax(places2_root, mode, res):
    _, t = _same({"type": "places2", "root_dir": places2_root, "mode": mode,
                  "resolution": res})
    assert t[0]["image"].shape == (3, res, res)


def test_json_simple_openimages_texture_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    root = str(tmp_path)
    jinfo = {}
    for i in range(4):
        rel = f"images1024x1024/{i:05d}.png"
        _save(osp.join(root, rel), _rgb(rng, 16, 16))
        jinfo[str(i)] = {"category": "training" if i < 2 else "validation",
                         "image": {"file_path": rel}}
    jinfo["9"] = {"category": "training",
                  "image": {"file_path": "images1024x1024/99999.png"}}
    with open(osp.join(root, "ffhq-dataset-v2.json"), "w") as f:
        json.dump(jinfo, f)
    for mode in ("train", "val", "train+val"):
        _same({"type": "ffhq", "root_dir": root, "mode": mode,
               "allow_partial": True, "resolution": 8})
    for get in (jds.get_dataset, tds.get_dataset):
        with pytest.raises(ValueError):
            get({"type": "ffhq", "root_dir": root, "mode": "train"})

    for sub in ("00000", "01000"):
        for k in range(2):
            _save(osp.join(root, "ffhq256x256", sub, f"{sub[:2]}{k:03d}.png"),
                  _rgb(rng, 12, 12))
    _same({"type": "ffhqsimple", "root_dir": root, "mode": "train256"})

    for name, (w, h) in (("validation/a.jpg", (40, 20)),
                         ("validation/s/b.png", (10, 30)),
                         ("validation/c.png", (8, 8))):
        _save(osp.join(root, "oi", name), _rgb(rng, h, w))
    _, t = _same({"type": "openimages", "root_dir": osp.join(root, "oi"),
                  "mode": "val", "resolution": 16})
    assert [e["unique_id"] for e in t.load_info] == ["a", "c", "s-b"]
    assert t[0]["content_size"] == (8, 16)

    tex = osp.join(root, "tex")
    lines = []
    for tt in ("banded", "dotted"):
        for k in range(3):
            _save(osp.join(tex, "dtd", "images", tt, f"{tt}_{k}.jpg"),
                  _rgb(rng, 10, 14))
            lines.append(f"{tt}/{tt}_{k}.jpg")
    os.makedirs(osp.join(tex, "dtd", "labels"))
    for m, sel in (("train1", lines[:4]), ("val1", lines[4:])):
        with open(osp.join(tex, "dtd", "labels", m + ".txt"), "w") as f:
            f.write("\n".join(sel) + "\n")
    for mixed in (False, True):
        _same({"type": "texture", "root_dir": tex, "mode": "train1+val1",
               "resolution": 8, "mixed_order_on_texture_type": mixed})


def _gen_dir(tmp_path, uids, res, seed=3):
    d = tmp_path / "gen"
    d.mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    for k, uid in enumerate(uids):
        ext = ".jpg" if k == 1 else ".png"
        Image.fromarray(_rgb(rng, res, res)).save(d / f"{uid}{ext}")
    return str(d)


def test_loadgen_pairings_match_jax(tmp_path, ffhq_zip, places2_root):
    gen = _gen_dir(tmp_path, [f"{i:05d}" for i in range(12)] + [
        "a", "b_c", "Z"] + [f"syn{i:05d}" for i in range(6)], 16)
    _same({"type": "ffhqzip_loadgen", "root_dir": ffhq_zip,
           "mode": "val256", "args": {"gen_dir": gen}})
    _same({"type": "places2_loadgen", "root_dir": places2_root,
           "mode": "val", "resolution": 16, "args": {"gen_dir": gen}})
    _, t = _same({"type": "loadgen", "args": {
        "base": {"type": "synthetic", "args": {"resolution": 16,
                                               "length": 6}},
        "gen_dir": gen}})
    assert t[2]["gen"].shape == (3, 16, 16)
    bad = tds.get_dataset({"type": "loadgen", "args": {
        "base": {"type": "synthetic", "args": {"resolution": 16,
                                               "length": 7}},
        "gen_dir": gen}})
    with pytest.raises(FileNotFoundError, match="syn00006"):
        bad[6]


def test_debug_fallback_keeps_the_loadgen_pairing(tmp_path):
    gen = _gen_dir(tmp_path, [f"syn{i:05d}" for i in range(64)], 32)
    cfg = {"type": "places2", "root_dir": str(tmp_path / "none"),
           "mode": "val", "resolution": 32, "gen_dir": gen}
    j, t = _same(cfg, fallback_synthetic=True)
    assert isinstance(t, tds.LoadGenDataset) and len(t) == 64
    assert isinstance(t.base, tds.SyntheticDataset) and t.base.resolution == 32
    cfg.pop("gen_dir")
    _, t = _same(cfg, fallback_synthetic=True)
    assert isinstance(t, tds.SyntheticDataset)


def test_every_configured_dataset_type_builds():
    """Each dataset of the bank names a type the port has; without its
    data root it raises FileNotFoundError as in JAX, and under
    ``fallback_synthetic`` gives the same synthetic stand-in."""
    tb, jb = dataset_cfg_bank(), j_bank()
    names = sorted(tb.raw)
    assert names == sorted(jb.raw)
    typed = [n for n in names if tb(n).get("type") not in (None, "synthetic",
                                                          "imagedir")]
    assert len(typed) >= 20
    for n in typed:
        cfg = tb(n)
        cfg["root_dir"] = "/nonexistent/shgan-data"
        assert cfg["type"] in tds._DATASET_REGISTRY, n
        with pytest.raises(FileNotFoundError):
            tds.get_dataset(cfg)
        t = tds.get_dataset(cfg, fallback_synthetic=True)
        j = jds.get_dataset(dict(cfg), fallback_synthetic=True)
        assert type(t).__name__ == type(j).__name__ == "SyntheticDataset"
        assert t.resolution == j.resolution
