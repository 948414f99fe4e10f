"""Freeform mask generators, host-side numpy (port of
``shgan_tpu/data/masks.py``).

* CoModGAN ``random_mask``: random rectangles plus polyline brush strokes
  with a hole-ratio rejection loop; float32, 1 = keep, 0 = hole.
* LaMa ``MixedMaskGenerator``: irregular strokes, boxes, squares and
  super-resolution grids, probability-mixed, with thin / medium / thick
  presets at 256 and 512 (``lama_generator``); float32, 1 = hole (the
  ``LamaMaskFormatter`` inverts it).  Its strokes are drawn by
  ``cv2.line``, so these masks need OpenCV.

The numpy call order is the JAX package's, so a seeded ``R`` (see
:mod:`.rng`) gives bit-identical masks in both packages.
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image, ImageDraw

from .rng import R as _R


def random_brush(max_tries, s, min_num_vertex=4, max_num_vertex=18,
                 mean_angle=2 * math.pi / 5, angle_range=2 * math.pi / 15,
                 min_width=12, max_width=48):
    """Polyline brush strokes rasterized with PIL (1 = stroked)."""
    H, W = s, s
    average_radius = math.sqrt(H * H + W * W) / 8
    mask = Image.new("L", (W, H), 0)
    for _ in range(_R.randint(max_tries)):
        num_vertex = _R.randint(min_num_vertex, max_num_vertex)
        angle_min = mean_angle - _R.uniform(0, angle_range)
        angle_max = mean_angle + _R.uniform(0, angle_range)
        angles = []
        vertex = []
        for i in range(num_vertex):
            if i % 2 == 0:
                angles.append(2 * math.pi - _R.uniform(angle_min, angle_max))
            else:
                angles.append(_R.uniform(angle_min, angle_max))

        h, w = mask.size
        vertex.append((int(_R.randint(0, w)), int(_R.randint(0, h))))
        for i in range(num_vertex):
            r = np.clip(_R.normal(loc=average_radius,
                                  scale=average_radius // 2),
                        0, 2 * average_radius)
            new_x = np.clip(vertex[-1][0] + r * math.cos(angles[i]), 0, w)
            new_y = np.clip(vertex[-1][1] + r * math.sin(angles[i]), 0, h)
            vertex.append((int(new_x), int(new_y)))

        draw = ImageDraw.Draw(mask)
        width = int(_R.uniform(min_width, max_width))
        draw.line(vertex, fill=1, width=width)
        for v in vertex:
            draw.ellipse((v[0] - width // 2, v[1] - width // 2,
                          v[0] + width // 2, v[1] + width // 2), fill=1)
        # two draws whose flips the reference never applies: kept so the
        # RNG stream stays the JAX package's
        _R.random()
        _R.random()
    mask = np.asarray(mask, np.uint8)
    if _R.random() > 0.5:
        mask = np.flip(mask, 0)
    if _R.random() > 0.5:
        mask = np.flip(mask, 1)
    return mask


def random_mask(s, hole_range=(0, 1)):
    """CoModGAN freeform mask with hole-ratio rejection.  Returns float32
    [1, s, s], 1 = keep."""
    coef = min(hole_range[0] + hole_range[1], 1.0)
    while True:
        mask = np.ones((s, s), np.uint8)

        def fill(max_size):
            w, h = _R.randint(max_size), _R.randint(max_size)
            ww, hh = w // 2, h // 2
            x = _R.randint(-ww, s - w + ww)
            y = _R.randint(-hh, s - h + hh)
            mask[max(y, 0): min(y + h, s), max(x, 0): min(x + w, s)] = 0

        def multi_fill(max_tries, max_size):
            for _ in range(_R.randint(max_tries)):
                fill(max_size)

        multi_fill(int(10 * coef), s // 2)
        multi_fill(int(5 * coef), s)
        mask = np.logical_and(mask, 1 - random_brush(int(20 * coef), s))
        hole_ratio = 1 - np.mean(mask)
        if hole_range is not None and (hole_ratio <= hole_range[0]
                                       or hole_ratio >= hole_range[1]):
            continue
        return mask[np.newaxis, ...].astype(np.float32)


# ---------------------------------------------------------------------------
# LaMa masks: 1 = hole in the raw output
# ---------------------------------------------------------------------------

LAMA_SETTINGS = {
    ("thin", 512): dict(
        irregular_proba=1,
        irregular_kwargs=dict(min_times=4, max_times=70, max_width=20,
                              max_angle=4, max_len=100),
        box_proba=0, squares_proba=0),
    ("medium", 512): dict(
        irregular_proba=1,
        irregular_kwargs=dict(min_times=4, max_times=10, max_width=100,
                              max_angle=4, max_len=200),
        box_proba=0.3,
        box_kwargs=dict(margin=0, bbox_min_size=30, bbox_max_size=150,
                        max_times=5, min_times=1),
        squares_proba=0),
    ("thick", 512): dict(
        irregular_proba=1,
        irregular_kwargs=dict(min_times=1, max_times=5, max_width=250,
                              max_angle=4, max_len=450),
        box_proba=0.3,
        box_kwargs=dict(margin=10, bbox_min_size=30, bbox_max_size=300,
                        max_times=4, min_times=1),
        squares_proba=0),
    ("thin", 256): dict(
        irregular_proba=1,
        irregular_kwargs=dict(min_times=4, max_times=50, max_width=10,
                              max_angle=4, max_len=40),
        box_proba=0, squares_proba=0),
    ("medium", 256): dict(
        irregular_proba=1,
        irregular_kwargs=dict(min_times=4, max_times=5, max_width=50,
                              max_angle=4, max_len=100),
        box_proba=0.3,
        box_kwargs=dict(margin=0, bbox_min_size=10, bbox_max_size=50,
                        max_times=5, min_times=1),
        squares_proba=0),
    ("thick", 256): dict(
        irregular_proba=1,
        irregular_kwargs=dict(min_times=1, max_times=5, max_width=100,
                              max_angle=4, max_len=200),
        box_proba=0.3,
        box_kwargs=dict(margin=10, bbox_min_size=30, bbox_max_size=150,
                        max_times=3, min_times=1),
        squares_proba=0),
}


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "LaMa masks draw their strokes with cv2.line and need OpenCV "
            "(the opencv-python package); another rasterizer would give "
            "other masks") from e
    return cv2


def make_random_irregular_mask(shape, max_angle=4, max_len=60, max_width=20,
                               min_times=0, max_times=10,
                               draw_method="line"):
    """Polyline strokes (``line``), discs (``circle``) or squares."""
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    times = _R.randint(min_times, max_times + 1)
    for i in range(times):
        start_x = _R.randint(width)
        start_y = _R.randint(height)
        for _ in range(1 + _R.randint(5)):
            angle = 0.01 + _R.randint(max_angle)
            if i % 2 == 0:
                angle = 2 * 3.1415926 - angle
            length = 10 + _R.randint(max_len)
            brush_w = 5 + _R.randint(max_width)
            end_x = np.clip((start_x + length * np.sin(angle))
                            .astype(np.int32), 0, width)
            end_y = np.clip((start_y + length * np.cos(angle))
                            .astype(np.int32), 0, height)
            if draw_method == "line":
                _cv2().line(mask, (start_x, start_y),
                            (int(end_x), int(end_y)), 1.0, brush_w)
            elif draw_method == "circle":
                _cv2().circle(mask, (start_x, start_y), radius=brush_w,
                              color=1.0, thickness=-1)
            elif draw_method == "square":
                radius = brush_w // 2
                mask[start_y - radius: start_y + radius,
                     start_x - radius: start_x + radius] = 1
            start_x, start_y = end_x, end_y
    return mask[None, ...]


def make_random_rectangle_mask(shape, margin=10, bbox_min_size=30,
                               bbox_max_size=100, min_times=0, max_times=3):
    """Random boxes."""
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    bbox_max_size = min(bbox_max_size, height - margin * 2,
                        width - margin * 2)
    times = _R.randint(min_times, max_times + 1)
    for _ in range(times):
        box_width = _R.randint(bbox_min_size, bbox_max_size)
        box_height = _R.randint(bbox_min_size, bbox_max_size)
        start_x = _R.randint(margin, width - margin - box_width + 1)
        start_y = _R.randint(margin, height - margin - box_height + 1)
        mask[start_y: start_y + box_height,
             start_x: start_x + box_width] = 1
    return mask[None, ...]


def make_random_superres_mask(shape, min_step=2, max_step=4, min_width=1,
                              max_width=3):
    """A regular sub-sampling grid."""
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    step_x = _R.randint(min_step, max_step + 1)
    width_x = _R.randint(min_width, min(step_x, max_width + 1))
    offset_x = _R.randint(0, step_x)
    step_y = _R.randint(min_step, max_step + 1)
    width_y = _R.randint(min_width, min(step_y, max_width + 1))
    offset_y = _R.randint(0, step_y)
    for dy in range(width_y):
        mask[offset_y + dy::step_y] = 1
    for dx in range(width_x):
        mask[:, offset_x + dx::step_x] = 1
    return mask[None, ...]


class MixedMaskGenerator:
    """Probability-mixed LaMa mask generator: ``__call__(img_chw)`` →
    float32 [1, H, W] with 1 = hole."""

    def __init__(self, irregular_proba=1 / 3, irregular_kwargs=None,
                 box_proba=1 / 3, box_kwargs=None, segm_proba=0,
                 segm_kwargs=None, squares_proba=0, squares_kwargs=None,
                 superres_proba=0, superres_kwargs=None, invert_proba=0):
        del segm_proba, segm_kwargs  # disabled in the reference too
        self.probas = []
        self.gens = []
        # the reference's generators recompute their limits from a ramp
        # coefficient even without a ramp (coefficient 1), which moves
        # some limits up by one; kept, so seeded masks stay the same
        if irregular_proba > 0:
            kw = dict(irregular_kwargs or {})
            kw["draw_method"] = "line"
            mn, mx = kw.get("min_times", 0), kw.get("max_times", 10)
            kw["max_times"] = int(mn + 1 + (mx - mn))
            kw["max_len"] = int(max(1, kw.get("max_len", 60)))
            kw["max_width"] = int(max(1, kw.get("max_width", 20)))
            self.probas.append(irregular_proba)
            self.gens.append(
                lambda shape, kw=kw: make_random_irregular_mask(shape, **kw))
        if box_proba > 0:
            kw = dict(box_kwargs or {})
            mn = kw.get("bbox_min_size", 30)
            mx = kw.get("bbox_max_size", 100)
            kw["bbox_max_size"] = int(mn + 1 + (mx - mn))
            self.probas.append(box_proba)
            self.gens.append(
                lambda shape, kw=kw: make_random_rectangle_mask(shape, **kw))
        if squares_proba > 0:
            kw = dict(squares_kwargs or {})
            kw["draw_method"] = "square"
            mn, mx = kw.get("min_times", 0), kw.get("max_times", 10)
            kw["max_times"] = int(mn + 1 + (mx - mn))
            self.probas.append(squares_proba)
            self.gens.append(
                lambda shape, kw=kw: make_random_irregular_mask(shape, **kw))
        if superres_proba > 0:
            kw = dict(superres_kwargs or {})
            self.probas.append(superres_proba)
            self.gens.append(
                lambda shape, kw=kw: make_random_superres_mask(shape, **kw))
        self.probas = np.array(self.probas, dtype="float32")
        self.probas /= self.probas.sum()
        self.invert_proba = invert_proba

    def __call__(self, img, iter_i=None):
        import random as _random
        kind = _R.choice(len(self.probas), p=self.probas)
        result = self.gens[kind](tuple(img.shape[1:]))
        # the reference draws the inversion from Python's random
        if self.invert_proba > 0 and _random.random() < self.invert_proba:
            result = 1 - result
        return result


def lama_generator(type="thin", resolution=256):
    return MixedMaskGenerator(**LAMA_SETTINGS[(type, resolution)])
