"""The traced run's reading of ``torch.profiler``: the device's activity
(kernels, copies and sets) as intervals on the host's clock, the host spans
(``record_function`` ranges: the benchmark's ``bench.*`` and the port's
training phases), and what the per-layer metrics and the ``breakdown`` take
from them.

The kernel grouping is a copy of the one the port's serving profile tool
used; the first pattern that a lower-cased kernel name contains wins.
"""

from __future__ import annotations

import bisect
from contextlib import contextmanager

GROUPS = (
    ("noise_bias_act_grad (epilogue's grad kernel)",
     ("noise_bias_act_grad", "grad_finish")),
    ("noise_bias_act (fused epilogue)", ("noise_bias_act",)),
    ("upfirdn2d (K2)", ("upfirdn2d",)),
    ("philox_normal (K1)", ("philox_normal",)),
    ("optimizer (Adam, foreach)", ("multi_tensor",)),
    ("convolution", ("conv", "xmma", "implicit", "gemm", "cutlass", "sm90",
                     "sm80", "winograd", "dgrad", "wgrad", "fprop")),
    ("fft", ("fft", "regular_fft", "vector_fft")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "cat")),
)

# the port's own record_function spans, beside the benchmark's bench.*
PORT_SPANS = ("Gmain", "Gpl", "Dmain", "R1", "opt_ema")


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """The reduced trace of one window (times in microseconds on the
    profiler's clock)."""

    def __init__(self, device_events, spans):
        self.window = next((a, b) for n, a, b in spans if n == "bench.window")
        lo, hi = self.window
        self.kernels = [(a, b, n) for a, b, n in device_events
                        if b > lo and a < hi]
        self.busy = _union([(max(a, lo), min(b, hi))
                            for a, b, _ in self.kernels])
        self._starts = [a for a, _ in self.busy]
        self.spans = spans

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy) / 1e6

    def busy_in(self, a, b):
        """Device-busy microseconds inside [a, b]."""
        i = max(bisect.bisect_right(self._starts, a) - 1, 0)
        t = 0.0
        while i < len(self.busy) and self.busy[i][0] < b:
            x, y = self.busy[i]
            t += max(0.0, min(y, b) - max(x, a))
            i += 1
        return t

    def spans_named(self, name):
        return [(a, b) for n, a, b in self.spans if n == name]

    def by_group(self):
        out = {}
        for a, b, n in self.kernels:
            g = group_of(n)
            out[g] = out.get(g, 0.0) + (b - a) / 1e6
        return out

    def seconds_of(self, pattern):
        """Device seconds of the kernels whose lower-cased name holds
        ``pattern``."""
        return sum(b - a for a, b, n in self.kernels
                   if pattern in n.lower()) / 1e6

    def idle_gaps(self, top=10):
        """The ``top`` longest idle gaps of the window, each named by the
        innermost host span open across it."""
        lo, hi = self.window
        edges = [lo] + [v for iv in self.busy for v in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        inner = [s for s in self.spans if s[0] != "bench.window"]
        out = []
        for a, b in gaps[:top]:
            best = None
            for n, x, y in inner:
                if x <= a and y >= b and (best is None
                                          or y - x < best[2] - best[1]):
                    best = (n, x, y)
            out.append([best[0] if best else "bench.window", (b - a) / 1e6])
        return out

    def breakdown(self, top=10):
        ops = sorted(self.by_group().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": self.idle_gaps(top)}


@contextmanager
def profiled(enabled):
    """``torch.profiler`` over the block where ``enabled``; yields a holder
    whose ``trace`` is the :class:`Trace` once the block has ended.  The
    block opens a ``bench.window`` span around its window."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    dev, spans = [], []
    names = set(PORT_SPANS)
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((a, b, e.name))
        elif e.name.startswith("bench.") or e.name in names:
            spans.append((e.name, a, b))
    holder.trace = Trace(dev, spans) if torch.cuda.is_available() else None
