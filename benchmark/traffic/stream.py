"""Driver of streamed batches: a batch job through
``InpaintEngine.inpaint_stream`` (the path of ``generate_to_dir``), fed
batches of the mix's size from a pool of images and masks made from the
seed before the window.

The window counts every composite returned to the host before it closes;
batches still in flight then are drained and not counted.  Mix parameters:
``batch`` (rows a batch), ``window`` (batches in flight), ``pool`` (images
and masks made), ``hole_range``; the cell's settings give the engine's
arguments and ``check_batches``, the batches kept for the check.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
from torch.profiler import record_function

from harness.serving import Reservoir, Serving
from harness.trace import profiled


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.serving = Serving(cell)

    def _batch(self, b):
        """The images and masks of global batch ``b``: one of the pool's
        batches, made before the window (so feeding the engine costs the
        loop no copy)."""
        return self.batches[b % len(self.batches)]

    def setup(self):
        t = self.cell.traffic
        self.engine = self.serving.build(
            batch_size=t["batch"], **self.cell.settings.get("engine", {}))
        s, n = self.serving, t["batch"]
        p = len(s.images)
        self.batches = [
            (np.ascontiguousarray(s.images[[(b * n + j) % p for j in range(n)]]),
             np.ascontiguousarray(s.masks[[(b * n + 5 * j + b) % p
                                           for j in range(n)]]))
            for b in range(int(t.get("batches", 4)))]
        # warm-up: the one graph key of the cell's batch shape
        for _ in self.engine.inpaint_stream(
                (self._batch(b) for b in range(t["window"] + 1)),
                window=t["window"]):
            pass

    def window(self, tracing):
        t, cell = self.cell.traffic, self.cell
        seconds = min(cell.seconds, t.get("trace_seconds", cell.seconds)) \
            if tracing else cell.seconds
        n = t["batch"]
        keep = Reservoir(int(cell.settings.get("check_batches", 4)), cell.seed)
        meta = deque()
        base = 1 << 20          # global positions of the window's rows
        with profiled(tracing) as prof:
            with record_function("bench.window"):
                t0 = cell.start_window()
                deadline = t0 + seconds

                def batches():
                    b = 0
                    while time.perf_counter() < deadline:
                        imgs, masks = self._batch(b)
                        meta.append((imgs, masks, base + b * n))
                        b += 1
                        yield imgs, masks

                done = submitted = 0
                for out in self.engine.inpaint_stream(
                        batches(), start_index=base, window=t["window"]):
                    if time.perf_counter() <= deadline:
                        done += out.shape[0]
                        keep.offer(meta[0] + (out,))
                    meta.popleft()
                    submitted += out.shape[0]
        for imgs, masks, start, out in keep.items:
            self.serving.keep(imgs, masks, start, out.shape[0], out)
        self.log(f"stream: {done} images in {seconds} s "
                 f"({keep.seen} batches returned in the window)")
        return {"e2e": {"serve_images_per_s": done / seconds},
                "attempted": submitted, "failed": 0,
                "trace": prof.trace,
                "facts": {"images": done, "seconds": seconds,
                          "batches": [n] * (submitted // n)}}

    def release(self):
        self.serving.release()

    def check(self):
        return self.serving.check()
