"""What the serving drivers share: the engine built from the cell's
configuration file with the benchmark's weights, the input pool, and the
check of served composites against the plain reference.

The engine is the port's public ``shgan_torch.serve.InpaintEngine``; its
generator gets the benchmark's weights through ``load_state_dict(strict=
True)``.  The check runs once the window has closed and the engine is
freed: it draws the weights again from the seed, recomputes each sampled
padded batch with ``reference/generator.py`` (float32, TF32 off) and
compares the served uint8 composites with it.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import generator as ref

from . import inputs


class Serving:
    """The engine and pool of a serving cell."""

    def __init__(self, cell):
        self.cell = cell
        self.model = cell.config["model"]
        self.res = self.model["args"]["synthesis"]["args"]["resolution"]
        self.seed = cell.seed
        self.engine = None
        self.template = None
        self.samples = []     # (images, masks, start, valid rows, output)

    def build(self, **engine_args):
        from shgan_torch.serve import InpaintEngine
        c = self.cell
        self.engine = InpaintEngine(self.model, seed=self.seed,
                                    device=c.device, **engine_args)
        G = self.engine.G
        sd = G.state_dict()
        self.template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                         for k, v in sd.items()}
        G.load_state_dict(inputs.weights(self.template, self.model,
                                         self.seed, c.device), strict=True)
        n = int(c.traffic.get("pool", 16))
        self.images, self.masks = inputs.pool(
            self.seed, n, self.res, tuple(c.traffic.get("hole_range", (0, 1))))
        return self.engine

    def release(self):
        if self.engine is not None:
            self.engine.close()
            self.engine = None
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def keep(self, images, masks, start, valid, out):
        self.samples.append((images, masks, start, valid, out))

    def check(self):
        """The numbers compared, each ``(name, value, limit)`` (value must
        not exceed limit)."""
        dev = self.cell.device
        limits = self.cell.settings["limits"]
        tf = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            P = inputs.weights(self.template, self.model, self.seed, dev)
            consts = ref.constants(self.model, dev)
            changed = off = holes = 0
            sq = 0.0
            for images, masks, start, valid, out in self.samples:
                want = ref.composite(
                    P, self.model, torch.from_numpy(images).to(dev),
                    torch.from_numpy(masks).to(dev), self.seed, start,
                    consts)[:valid]
                got = torch.from_numpy(np.ascontiguousarray(out)).to(dev)
                kept = torch.from_numpy(masks[:valid]).to(dev).bool() \
                    .expand_as(got)
                src = torch.from_numpy(images[:valid]).to(dev)
                changed += int((got != src)[kept].sum())
                gap = (got.float() - torch.floor(want))[~kept]
                off += int((gap.abs() > 1).sum())
                sq += float(gap.square().sum())
                holes += gap.numel()
        finally:
            torch.backends.cudnn.allow_tf32, \
                torch.backends.cuda.matmul.allow_tf32 = tf
        holes = max(holes, 1)
        return [("kept_px_changed", changed, limits["kept_px_changed"]),
                ("hole_px_off_pct", 100.0 * off / holes,
                 limits["hole_px_off_pct"]),
                ("hole_rms_levels", (sq / holes) ** 0.5,
                 limits["hole_rms_levels"])]


class Reservoir:
    """A uniform sample of ``k`` items from a stream, drawn from ``seed``."""

    def __init__(self, k, seed):
        self.k = k
        self.items = []
        self.seen = 0
        self.rng = np.random.RandomState(seed % (2 ** 32))

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randint(self.seen)
            if j < self.k:
                self.items[j] = item
