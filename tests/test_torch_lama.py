"""LaMa masks and the formatters: the port against shgan_tpu under the same
seeded ``R``.  Every ``LAMA_SETTINGS`` preset over three seeds, the
squares and super-resolution generators and the inversion, bit for bit;
all six formatters the port added bit for bit, but the float bicubic of
``AdvInpaintingFormatter`` (≤ 1e-6); OpenCV's absence raises."""

import random
import sys

import numpy as np
import pytest
from PIL import Image

from shgan_tpu.data import formatters as jf
from shgan_tpu.data import masks as jm
from shgan_tpu.data.rng import batch_rng as j_rng
from shgan_torch.data import formatters as tf
from shgan_torch.data import masks as tm
from shgan_torch.data.rng import batch_rng as t_rng

ADV_ATOL = 1e-6


def _both(fn_j, fn_t, seed, py_seed=None):
    """fn under each package's seeded R (and Python's random, where the
    generator draws from it)."""
    out = []
    for scope, fn in ((j_rng, fn_j), (t_rng, fn_t)):
        if py_seed is not None:
            random.seed(py_seed)
        with scope(seed):
            out.append(fn())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("key", sorted(jm.LAMA_SETTINGS))
def test_lama_presets_bit_identical(key, seed):
    assert tm.LAMA_SETTINGS[key] == jm.LAMA_SETTINGS[key]
    img = np.zeros((3, key[1], key[1]), np.float32)
    j, t = _both(lambda: jm.lama_generator(*key)(img),
                 lambda: tm.lama_generator(*key)(img), seed)
    assert t.dtype == j.dtype == np.float32 and t.shape == (1,) + img.shape[1:]
    assert 0 < t.sum() < t.size
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_squares_superres_and_inversion_bit_identical(seed):
    kw = dict(irregular_proba=0, box_proba=0, squares_proba=1,
              squares_kwargs=dict(min_times=2, max_times=6, max_width=30),
              superres_proba=1, superres_kwargs={}, invert_proba=0.5)
    img = np.zeros((3, 64, 64), np.float32)
    j, t = _both(lambda: [jm.MixedMaskGenerator(**kw)(img)
                          for _ in range(6)],
                 lambda: [tm.MixedMaskGenerator(**kw)(img)
                          for _ in range(6)], seed, py_seed=seed)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)
    for gen, kw in (("make_random_superres_mask", {}),
                    ("make_random_rectangle_mask",
                     dict(margin=2, bbox_min_size=5, bbox_max_size=15,
                          min_times=1, max_times=4))):
        a, b = _both(lambda: getattr(jm, gen)((48, 40), **kw),
                     lambda: getattr(tm, gen)((48, 40), **kw), seed)
        assert 0 < b.sum() < b.size
        np.testing.assert_array_equal(b, a)
    a, b = _both(lambda: jm.make_random_irregular_mask(
                     (40, 48), draw_method="circle"),
                 lambda: tm.make_random_irregular_mask(
                     (40, 48), draw_method="circle"), seed)
    np.testing.assert_array_equal(b, a)


def test_lama_needs_opencv(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    gen = tm.lama_generator("thin", 256)     # builds without drawing
    with pytest.raises(ImportError, match="opencv"):
        gen(np.zeros((3, 256, 256), np.float32))


def _element(seed, res=32, **extra):
    rng = np.random.RandomState(seed)
    return dict({"image": rng.rand(3, res, res).astype(np.float32),
                 "unique_id": f"u{seed}"}, **extra)


def _formatted_equal(jfmt, tfmt, el, seed, atol=0.0):
    j, t = _both(lambda: jfmt(dict(el)), lambda: tfmt(dict(el)), seed)
    assert t[2] == j[2]
    for a, b in zip(j[:2], t[:2]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if atol:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(b, a)
    return t


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,args,extra", [
    ("LamaMaskFormatter", dict(random_flip=True, resolution=256,
                               type="medium"), {}),
    ("FreeFormMaskFormatter", dict(random_flip=True, resolution=32,
                                   impl="numpy"), {"content_size": (20, 12)}),
    ("FreeFormMaskFormatter", dict(random_flip=False, resolution=32,
                                   impl="numpy"), {}),
    ("CenterMaskFormatter", {}, {}),
    ("NoMaskFormatter", {}, {}),
])
def test_formatters_bit_identical(name, args, extra, seed):
    res = args.get("resolution", 32)
    el = _element(seed, res, **extra)
    cfg = {"type": name, "args": args}
    _, mask, _ = _formatted_equal(jf.get_formatter(cfg),
                                  tf.get_formatter(cfg), el, seed)
    if "content_size" in extra:
        h, w = extra["content_size"]
        assert (mask[:, w:] == 1).all() and (mask[h:, :] == 1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adv_inpainting_formatter(seed):
    cfg = {"type": "AdvInpaintingFormatter",
           "args": {"resolution": 32, "impl": "numpy"}}
    t = _formatted_equal(jf.get_formatter(cfg), tf.get_formatter(cfg),
                         _element(seed, 30), seed, atol=ADV_ATOL)
    assert t[0].shape == (3, 32, 32)
    assert tf.AdvInpaintingFormatter.alters_pixels


def test_fixed_mask_formatter_thresholds(tmp_path):
    """Anti-aliased grey edges: keep where the value is above 128."""
    ramp = np.tile(np.arange(0, 256, 8, dtype=np.uint8), (32, 1))
    Image.fromarray(ramp).save(tmp_path / "u3_mask.png")
    cfg = {"type": "FixedMaskFormatter", "args": {"mask_dir": str(tmp_path)}}
    _, mask, _ = _formatted_equal(jf.get_formatter(cfg),
                                  tf.get_formatter(cfg), _element(3), 3)
    np.testing.assert_array_equal(mask[0], (ramp[0] > 128).astype(np.float32))
