"""CoModGAN freeform masks, host-side numpy (port of the CoModGAN part of
``shgan_tpu/data/masks.py``; the LaMa generators come later).

Random rectangles plus polyline brush strokes with a hole-ratio rejection
loop.  The numpy call order is the JAX package's, so a seeded ``R`` (see
:mod:`.rng`) gives bit-identical masks in both packages.  Masks are float32
with 1 = keep, 0 = hole.
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
