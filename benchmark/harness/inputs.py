"""The inputs a run makes from its seed: photo-like images, CoModGAN's
free-form hole masks and the generator's weights.

The mask generator is a frozen copy of CoModGAN's (random rectangles and
polyline brush strokes with a hole-ratio rejection loop), drawing from an
explicit ``np.random.RandomState`` so that the same seed gives the same
masks.  Weights are drawn on the device from one ``torch.Generator`` in one
call, then scaled key by key to the distribution of the port's
initializer; biases and noise strengths, which that initializer sets to
constants, get a spread of 0.1 around them, so that the comparison with the
reference sees the bias and noise paths.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from PIL import Image, ImageDraw


def _brush(rng, max_tries, s, min_num_vertex=4, max_num_vertex=18,
           mean_angle=2 * math.pi / 5, angle_range=2 * math.pi / 15,
           min_width=12, max_width=48):
    H = W = s
    average_radius = math.sqrt(H * H + W * W) / 8
    mask = Image.new("L", (W, H), 0)
    for _ in range(rng.randint(max_tries)):
        num_vertex = rng.randint(min_num_vertex, max_num_vertex)
        angle_min = mean_angle - rng.uniform(0, angle_range)
        angle_max = mean_angle + rng.uniform(0, angle_range)
        angles = [2 * math.pi - rng.uniform(angle_min, angle_max) if i % 2 == 0
                  else rng.uniform(angle_min, angle_max)
                  for i in range(num_vertex)]
        h, w = mask.size
        vertex = [(int(rng.randint(0, w)), int(rng.randint(0, h)))]
        for i in range(num_vertex):
            r = np.clip(rng.normal(loc=average_radius,
                                   scale=average_radius // 2),
                        0, 2 * average_radius)
            new_x = np.clip(vertex[-1][0] + r * math.cos(angles[i]), 0, w)
            new_y = np.clip(vertex[-1][1] + r * math.sin(angles[i]), 0, h)
            vertex.append((int(new_x), int(new_y)))
        draw = ImageDraw.Draw(mask)
        width = int(rng.uniform(min_width, max_width))
        draw.line(vertex, fill=1, width=width)
        for v in vertex:
            draw.ellipse((v[0] - width // 2, v[1] - width // 2,
                          v[0] + width // 2, v[1] + width // 2), fill=1)
    mask = np.asarray(mask, np.uint8)
    if rng.random_sample() > 0.5:
        mask = np.flip(mask, 0)
    if rng.random_sample() > 0.5:
        mask = np.flip(mask, 1)
    return mask


def free_form_mask(rng, s, hole_range=(0.0, 1.0)):
    """CoModGAN's free-form mask: uint8 [s, s], 1 = keep, 0 = hole, its
    hole ratio strictly inside ``hole_range``."""
    coef = min(hole_range[0] + hole_range[1], 1.0)
    while True:
        mask = np.ones((s, s), np.uint8)

        def fill(max_size):
            w, h = rng.randint(max_size), rng.randint(max_size)
            ww, hh = w // 2, h // 2
            x = rng.randint(-ww, s - w + ww)
            y = rng.randint(-hh, s - h + hh)
            mask[max(y, 0): min(y + h, s), max(x, 0): min(x + w, s)] = 0

        for _ in range(rng.randint(int(10 * coef))):
            fill(s // 2)
        for _ in range(rng.randint(int(5 * coef))):
            fill(s)
        mask = np.logical_and(mask, 1 - _brush(rng, int(20 * coef), s))
        hole = 1 - mask.mean()
        if hole_range[0] < hole < hole_range[1]:
            return mask.astype(np.uint8)


def photo(rng, s):
    """A photo-like uint8 [3, s, s] image: a smooth colour field (a few
    low-frequency waves and a gradient), edges of a few flat shapes and
    sensor-like grain."""
    y, x = np.mgrid[0:s, 0:s].astype(np.float32) / s
    img = np.empty((3, s, s), np.float32)
    for c in range(3):
        f = rng.uniform(0.2, 0.8) + rng.uniform(-0.3, 0.3) * (x + y - 1)
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 6, size=2)
            ph = rng.uniform(0, 2 * np.pi)
            f = f + rng.uniform(0.03, 0.12) * np.sin(
                2 * np.pi * (fx * x + fy * y) + ph)
        img[c] = f
    for _ in range(rng.randint(2, 6)):
        cx, cy, r = rng.uniform(0, 1), rng.uniform(0, 1), rng.uniform(0.05, .3)
        inside = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[:, inside] = rng.uniform(0.1, 0.9, size=(3, 1))
    img += rng.normal(0, 0.02, size=img.shape).astype(np.float32)
    return np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)


def pool(seed, n, s, hole_range=(0.0, 1.0)):
    """``n`` images [n, 3, s, s] and masks [n, 1, s, s], uint8, from
    ``seed``."""
    rng = np.random.RandomState(seed % (2 ** 32))
    imgs = np.stack([photo(rng, s) for _ in range(n)])
    masks = np.stack([free_form_mask(rng, s, hole_range)[None]
                      for _ in range(n)])
    return imgs, masks


def _scale(name, shape, model):
    """(mean, std) of parameter ``name`` under the port's initializer, a
    spread of 0.1 added to the constants."""
    a = model["args"]
    leaf = name.split(".")[-1]
    if leaf == "w_avg":
        return 0.0, 0.0
    if leaf == "noise_const":
        return 0.0, 1.0
    if leaf == "noise_strength":
        return 0.0, 0.1
    if leaf == "bias":
        return (1.0 if name.endswith("affine.bias") else 0.0), 0.1
    if name.startswith("mapping.fc"):
        return 0.0, 1.0 / a["mapping"]["args"]["lr_multiplier"]
    if name.endswith("shu.conv0.weight"):
        return 0.0, 1.0 / math.sqrt(int(np.prod(shape[1:])))
    if name.endswith("shu.df1.weight"):
        oc2 = 2 * a["encoder"]["args"]["shu_channels"]
        return 1.0 / oc2, 0.1 / oc2
    return 0.0, 1.0


@torch.no_grad()
def weights(template, model, seed, device):
    """A state dict with ``template``'s keys and shapes, drawn on
    ``device`` from ``seed`` in one call."""
    keys = sorted(template)
    total = sum(template[k].numel() for k in keys)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k in keys:
        shape = tuple(template[k].shape)
        n = template[k].numel()
        mean, std = _scale(k, shape, model)
        out[k] = (flat[at:at + n].view(shape) * std + mean).to(
            template[k].dtype)
        at += n
    return out
