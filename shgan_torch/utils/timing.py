"""Timing a call on its device (port of ``shgan_tpu/utils/timing.py``)."""

from __future__ import annotations

import time

import torch


def _first_tensor(r):
    if isinstance(r, torch.Tensor):
        return r
    if isinstance(r, dict):
        r = list(r.values())
    if isinstance(r, (list, tuple)):
        for v in r:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_timeit(fn, *args, iters=8, warmup=2):
    """Mean seconds a call of ``fn(*args)``, over ``iters`` calls after
    ``warmup`` (at least one).  When the result holds a CUDA tensor (its
    first tensor leaf), the calls are timed with CUDA events on the
    current stream; otherwise with ``time.perf_counter``."""
    for _ in range(max(warmup, 1)):   # one call at least: the device
        r = fn(*args)
    t = _first_tensor(r)
    if t is not None and t.is_cuda:
        with torch.cuda.device(t.device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
