"""The port's host data path against shgan_tpu's on the CPU: seeded masks
(numpy and native), RandomMaskFormatter, SyntheticDataset, transforms and
EvalPipeline batches (both transports, ragged last batch)."""

import numpy as np
import pytest
import torch

from shgan_tpu.data import masks as jmasks
from shgan_tpu.data import rng as jrng
from shgan_tpu.data.datasets import SyntheticDataset as JSynthetic
from shgan_tpu.data.datasets import get_dataset as j_get_dataset
from shgan_tpu.data.formatters import get_formatter as j_get_formatter
from shgan_tpu.data.pipeline import EvalPipeline as JPipeline
from shgan_tpu.data.transforms import wrap_formatter as j_wrap
from shgan_tpu.native import maskgen as jnative
from shgan_torch.data import masks, rng
from shgan_torch.data.datasets import SyntheticDataset, get_dataset
from shgan_torch.data.formatters import get_formatter
from shgan_torch.data.pipeline import EvalPipeline
from shgan_torch.data.transforms import get_transforms, wrap_formatter
from shgan_torch.native import maskgen


@pytest.mark.parametrize("s,hole_range,seed", [
    (64, (0, 1), 3), (256, (0, 1), 11), (256, (0.2, 0.6), 5)])
def test_random_mask_bit_identical(s, hole_range, seed):
    with jrng.batch_rng(seed):
        want = jmasks.random_mask(s, hole_range)
        want_next = jrng.R.randint(1 << 30)
    with rng.batch_rng(seed):
        got = masks.random_mask(s, hole_range)
        got_next = rng.R.randint(1 << 30)
    assert got.dtype == np.float32 and got.shape == (1, s, s)
    np.testing.assert_array_equal(got, want)
    assert got_next == want_next   # the same draws were consumed


def test_batch_rng_scopes_nest_and_fall_through():
    np.random.seed(4)
    a = rng.R.rand()
    np.random.seed(4)
    assert np.random.rand() == a          # outside a scope: np.random
    with rng.batch_rng(1):
        x = rng.R.rand()
        with rng.batch_rng(2):
            rng.R.rand()
        y = rng.R.rand()
    r = np.random.RandomState(1)
    assert (x, y) == (r.rand(), r.rand())
    assert rng.derive_seed(5, 7, 9) == jrng.derive_seed(5, 7, 9)


def test_native_masks_bit_identical():
    if not jnative.native_available():
        pytest.skip(f"g++ cannot build maskgen here: {jnative._LIB_ERR}")
    assert maskgen.native_available(), maskgen.load_error()
    for s in (64, 256):
        want = jnative.random_mask_batch(3, s, (0, 1), seed=9, num_threads=2)
        got = maskgen.random_mask_batch(3, s, (0, 1), seed=9, num_threads=2)
        assert got.shape == (3, 1, s, s)
        np.testing.assert_array_equal(got, want)


def test_mask_batch_numpy_impl_matches_jax():
    want = jnative.random_mask_batch(2, 64, seed=6, impl="numpy")
    got = maskgen.random_mask_batch(2, 64, seed=6, impl="numpy")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        maskgen.random_mask_batch(1, 8, impl="cuda")


def _fmt_cfg(impl, flip=True, res=64):
    return {"type": "RandomMaskFormatter",
            "args": {"random_flip": flip, "mask_resolution": res,
                     "hole_range": [0, 1], "impl": impl}}


@pytest.mark.parametrize("impl", ["numpy", "auto"])
@pytest.mark.parametrize("as_u8", [False, True])
def test_formatter_and_synthetic_match_jax(impl, as_u8):
    jds = JSynthetic(resolution=64, length=6, seed=2, pool=4, as_u8=as_u8)
    tds = SyntheticDataset(resolution=64, length=6, seed=2, pool=4,
                           as_u8=as_u8)
    jf, tf = j_get_formatter(_fmt_cfg(impl)), get_formatter(_fmt_cfg(impl))
    assert len(tds) == len(jds) == 6
    for i in range(6):
        je, te = jds[i], tds[i]
        assert te["unique_id"] == je["unique_id"]
        np.testing.assert_array_equal(te["image"], je["image"])
        with jrng.batch_rng(100 + i):
            jr, jm, ju = jf(je)
        with rng.batch_rng(100 + i):
            tr, tm, tu = tf(te)
        assert tu == ju
        assert np.asarray(tr).dtype == np.asarray(jr).dtype
        np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
        np.testing.assert_array_equal(tm, jm)


def test_native_impl_raises_when_unavailable(monkeypatch):
    monkeypatch.setattr(maskgen, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        get_formatter(_fmt_cfg("native"))
    f = get_formatter(_fmt_cfg("auto"))    # auto: the numpy masks
    with rng.batch_rng(1):
        _, m, _ = f({"image": np.zeros((3, 64, 64), np.float32),
                     "unique_id": "a"})
    with rng.batch_rng(1):
        rng.R.rand()                       # the flip draw
        want = masks.random_mask(64)[0]
    np.testing.assert_array_equal(m, want)


def test_transforms_match_jax():
    cfg = [{"type": "CenterCrop", "args": {"size": 48}},
           {"type": "Resize", "args": {"resolution": 64}},
           {"type": "RandomFlip", "args": {"p": 0.5}},
           "UniformNumpyType"]
    ds = SyntheticDataset(resolution=80, length=3, seed=1, as_u8=True)
    jwrapped = j_wrap(j_get_formatter(_fmt_cfg("numpy", flip=False)), cfg)
    twrapped = wrap_formatter(get_formatter(_fmt_cfg("numpy", flip=False)),
                              cfg)
    for i in range(3):
        with jrng.batch_rng(i):
            jr, jm, _ = jwrapped(ds[i])
        with rng.batch_rng(i):
            tr, tm, _ = twrapped(ds[i])
        assert tr.dtype == np.float32        # the stale uint8 copy dropped
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tm, jm)
    el = {"image": np.ones((3, 4, 4), np.float32), "unique_id": "x"}
    assert get_transforms(None)(el) is el


def _ds_cfg(**args):
    return {"type": "synthetic", "name": "syn",
            "args": dict(resolution=32, length=7, seed=3, **args),
            "formatter": _fmt_cfg("numpy", flip=True, res=32)}


@pytest.mark.parametrize("transport", ["f32", "u8"])
@pytest.mark.parametrize("as_u8", [False, True])
def test_eval_pipeline_batches_match_jax(transport, as_u8):
    """7 images in batches of 3: the last batch has 1 valid row and 2
    padding rows repeating it."""
    cfg = _ds_cfg(as_u8=as_u8, pool=4)
    jp = JPipeline(j_get_dataset(cfg), j_get_formatter(cfg["formatter"]), 3,
                   mesh=None, seed=5, num_threads=2, transport=transport)
    tp = EvalPipeline(get_dataset(cfg), get_formatter(cfg["formatter"]), 3,
                      seed=5, num_threads=2, transport=transport)
    assert len(tp) == len(jp) == 3
    jb, tb = list(jp), list(tp)
    for (jr, jm, jv, ju), (tr, tm, tv, tu) in zip(jb, tb):
        assert tr.dtype == np.asarray(jr).dtype
        assert tm.dtype == np.asarray(jm).dtype
        np.testing.assert_array_equal(tr, np.asarray(jr))
        np.testing.assert_array_equal(tm, np.asarray(jm))
        np.testing.assert_array_equal(tv, jv)
        assert tu == ju
    assert tb[-1][2].tolist() == [True, False, False]
    assert tb[-1][3] == ["syn00006"] * 3
    # on a device the batches are tensors with the same values
    dp = EvalPipeline(get_dataset(cfg), get_formatter(cfg["formatter"]), 3,
                      device="cpu", seed=5, num_threads=0,
                      transport=transport)
    for (tr, tm, _, _), (dr, dm, _, _) in zip(tb, dp):
        assert isinstance(dr, torch.Tensor) and isinstance(dm, torch.Tensor)
        np.testing.assert_array_equal(dr.numpy(), tr)
        np.testing.assert_array_equal(dm.numpy(), tm)


def test_pipeline_independent_of_threads():
    cfg = _ds_cfg()
    runs = [[b[0] for b in EvalPipeline(
        get_dataset(cfg), get_formatter(cfg["formatter"]), 2, seed=1,
        num_threads=n)] for n in (0, 1, 4)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)


def test_get_dataset_pick_fallback_and_missing(tmp_path):
    ds = get_dataset(dict(_ds_cfg(), pick=["syn00002", "syn00004"],
                          pick_repeat=2))
    assert [i["unique_id"] for i in ds.load_info] == ["syn00002",
                                                      "syn00004"] * 2
    missing = {"type": "imagedir", "root_dir": str(tmp_path / "none"),
               "resolution": 32}
    with pytest.raises(FileNotFoundError):
        get_dataset(missing)
    fb = get_dataset(missing, fallback_synthetic=True)
    assert isinstance(fb, SyntheticDataset) and fb.resolution == 32
    jfb = j_get_dataset(missing, fallback_synthetic=True)
    np.testing.assert_array_equal(fb[3]["image"], jfb[3]["image"])
    with pytest.raises(FileNotFoundError):   # no ffhq256x256.zip there
        get_dataset({"type": "ffhqzip", "root_dir": str(tmp_path)})


def test_imagedir_matches_jax(tmp_path):
    from PIL import Image
    r = np.random.RandomState(0)
    for name in ("b.png", "a.jpg", "sub/c.png"):
        p = tmp_path / name
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(r.randint(0, 256, (20, 24, 3), np.uint8)).save(p)
    cfg = {"type": "imagedir", "root_dir": str(tmp_path), "resolution": 16}
    jds, tds = j_get_dataset(cfg), get_dataset(cfg)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        assert tds[i]["unique_id"] == jds[i]["unique_id"]
        np.testing.assert_array_equal(tds[i]["image"], jds[i]["image"])
