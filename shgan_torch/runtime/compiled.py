"""The compiled forward: ``models/infer.composite_forward`` captured as one
CUDA graph per batch shape and replayed per batch, the port's counterpart
of the JAX package's ``jax.jit`` forward (``shgan_tpu/serve.py:122-133``,
``shgan_tpu/runtime/stages.py:294-300``): a batch costs one host call.

:class:`CompiledForward` keeps a graph per key: the batch, ``H``, ``W``,
the inputs' dtypes (uint8 or float32), ``noise_mode``, the model's bf16
setting and the backends' TF32 and cuDNN algorithm flags (read at capture,
as ``jax.jit`` reads a static argument).  For each key it holds static
``real``, ``mask``, ``z`` and noise-table tensors; the first batch of a key
warms the forward up on a side stream (cuDNN's and cuBLAS's handles,
cuFFT's plans, K3's shared-memory opt-in and the kernels' occupancy caches
are set there, not under capture), then captures it into a
``torch.cuda.CUDAGraph``.  Every graph of a model draws from one memory
pool (``torch.cuda.graph_pool_handle()``).  A call
copies the inputs into the statics (host inputs through a pinned buffer,
reused only after its last copy completed), writes the batch's noise table
(each noise layer's Philox key and first counter row: the fused epilogue
reads them from device memory, so a replay draws this batch's noise, not
the captured one's), replays the graph and returns a copy of the static
output, which the next replay overwrites.

Launch counts: the kernel wrappers count where they launch, in Python; a
replay launches without them.  The graph's counts are recorded at capture
(the warm-up, set-up like a trace, is taken back out of the counts, and so
are the capture's own, whose kernels ran no time) and added once per
replay; the NHWC counts (``kernels/build.launches_nhwc``) and the modulated
convs' (``kernels/build.modconv``) alike.

A call's host stages are spans (``runtime/tracing``): ``compiled.load``
(the staging wait, the copies and the table) and ``compiled.replay`` (the
replay and the output's copy).

On a CUDA device the captured forward holds its activations channels-last
(``composite_forward``'s ``memory_format``): cuDNN's convolutions read and
write them without layout transposes, and the hand-written kernels take
their NHWC index maps.  Every eager forward of the package stays NCHW.

On the CPU there is nothing to capture: a call writes the statics and the
table and runs ``composite_forward`` on them, NCHW.  On CUDA a failed capture
raises; it never falls back to the eager forward.  The forwards that stay
eager on CUDA are named by :func:`eager_reason`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels import build as _kb
from ..models.infer import composite_forward
from ..models.layers import SynthesisLayer
from ..ops.noise import noise_table
from ..parallel import spatial
from .tracing import span

WARMUP = 2   # eager forwards on the side stream before a capture


def noise_layer_ids(G):
    """The ``layer_id`` of every synthesis layer of ``G`` that draws noise."""
    return sorted(m.layer_id for m in G.modules()
                  if isinstance(m, SynthesisLayer) and m.use_noise)


def eager_reason(G, devices, ranks=1):
    """Why the composite forward of ``G`` over ``devices`` (and ``ranks``
    processes) runs eagerly, or None: :class:`CompiledForward` runs it (a
    graph on a CUDA device; on the CPU its statics, eagerly).  The eager
    configurations are these: several devices (the engine's blocks meet on
    host barriers, ``parallel.ThreadGroup``), several ranks (the style
    statistic's ``all_reduce`` runs through gloo on the host), the
    pluralistic synthesis (its ``w0`` draw is the host's, in the forward)
    and spatial sharding (halos go through the host)."""
    if len(devices) > 1:
        return "several devices: the blocks meet on host barriers"
    if ranks > 1:
        return "several ranks: the style statistic's all_reduce is the host's"
    if getattr(getattr(G, "synthesis", None), "plural", False):
        return "the pluralistic synthesis draws w0 on the host"
    if spatial.active() is not None:
        return "spatial sharding exchanges halos through the host"
    return None


def _as_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a)) \
        if isinstance(a, np.ndarray) else a


class _Statics:
    """The static tensors of one key: the device inputs the graph reads,
    their pinned host staging buffers (made at the first host input) and
    the event after the last copy out of them."""

    def __init__(self, device, real, mask, z, table_rows):
        self.device = device
        like = lambda t: torch.empty(t.shape, dtype=t.dtype,  # noqa: E731
                                     device=device)
        self.dev = {"real": like(real), "mask": like(mask), "z": like(z)}
        if table_rows:
            self.dev["table"] = torch.zeros((table_rows, 3),
                                            dtype=torch.int64, device=device)
        self.host = {}
        self.copied = None
        self.graph = self.out = None
        self.launches = {}
        self.launches_nhwc = {}
        self.modconv = {}

    def _pinned(self, name):
        if name not in self.host:
            t = self.dev[name]
            self.host[name] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
        return self.host[name]

    def load(self, inputs, fill_table):
        """Copy ``{name: tensor}`` into the statics; ``fill_table(out)``
        writes the noise table into a host tensor."""
        staged = self.device.type == "cuda"
        if staged and self.copied is not None:
            self.copied.synchronize()   # the staging buffers are free again
        if "table" in self.dev:
            inputs = dict(inputs, table=fill_table(
                self._pinned("table") if staged else
                torch.empty(self.dev["table"].shape, dtype=torch.int64)))
        for name, src in inputs.items():
            dst = self.dev[name]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"compiled forward: {name} is {src.dtype} "
                                 f"{tuple(src.shape)}, its graph's "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            if staged and src.device.type == "cpu":
                if name != "table":
                    src = self._pinned(name).copy_(src)
                dst.copy_(src, non_blocking=True)
            else:
                dst.copy_(src)
        if staged:
            self.copied = torch.cuda.Event()
            self.copied.record()


class CompiledForward:
    """``composite_forward(G, real, mask, z, noise_mode, ...)`` as one CUDA
    graph per key (the module docstring); on the CPU, the same forward run
    eagerly on the statics.  ``G`` stays on its device and in eval mode;
    ``records`` lists each capture: its key, seconds (warm-up and capture),
    launches per replay (all, and those on the NHWC maps), the modulated
    convs' counts per replay and pool bytes (the growth of the device's
    reserved memory over the capture, the cache emptied before it);
    ``last_path`` says how the last
    call ran: ``"capture"``, ``"replay"`` or, on the CPU, ``"eager"``."""

    def __init__(self, G, noise_mode="random"):
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}")
        self.G = G
        self.noise_mode = noise_mode
        self.device = next(G.parameters()).device
        self.captures = self.device.type == "cuda"
        self.layer_ids = noise_layer_ids(G) if noise_mode == "random" else []
        self.bf16 = any(getattr(m, "dtype", None) == torch.bfloat16
                        for m in G.modules())
        self.statics = {}
        self.pool = None
        self.records = []
        self.last_path = None

    def key(self, real, mask):
        n, _, h, w = real.shape
        c = torch.backends.cudnn
        # the backends' math flags are read at capture as well: a graph
        # replays the algorithms (TF32 or not) it was captured with
        return (n, h, w, real.dtype, mask.dtype, self.noise_mode, self.bf16,
                c.allow_tf32, c.deterministic, c.benchmark,
                torch.backends.cuda.matmul.allow_tf32)

    def __call__(self, real, mask, z, noise_seed=None, row0=0):
        """The uint8 composite of one batch: ``real`` / ``mask`` / ``z``
        tensors (on the host or the device) or numpy arrays, as
        ``composite_forward`` takes them; ``noise_seed`` (an integer) and
        ``row0`` key the random noise."""
        real, mask, z = _as_tensor(real), _as_tensor(mask), _as_tensor(z)
        if self.noise_mode == "random" and noise_seed is None:
            raise ValueError("noise_mode='random' requires a noise_seed")
        if self.captures and spatial.active() is not None:
            raise RuntimeError("the compiled forward does not run under "
                               "spatial sharding, which exchanges halos "
                               "through the host")
        key = self.key(real, mask)
        with torch.inference_mode():
            st = self.statics.get(key)
            fresh = st is None
            if fresh:
                st = self.statics[key] = _Statics(
                    self.device, real, mask, z,
                    self.layer_ids[-1] + 1 if self.layer_ids else 0)
            with span("compiled.load"):
                st.load({"real": real, "mask": mask, "z": z},
                        lambda out: noise_table(noise_seed, self.layer_ids,
                                                row0, out=out))
            if not self.captures:
                self.last_path = "eager"
                return self._forward(st)
            self.last_path = "capture" if fresh else "replay"
            if fresh:
                try:
                    self._compile(key, st)
                except BaseException:
                    del self.statics[key]   # no graph: raise, never eager
                    raise
            with span("compiled.replay"):
                return self._replay(st)

    def _forward(self, st):
        d = st.dev
        return composite_forward(
            self.G, d["real"], d["mask"], d["z"], noise_mode=self.noise_mode,
            noise_seed=d.get("table"),
            memory_format=(torch.channels_last if self.captures
                           else torch.contiguous_format))

    def _compile(self, key, st):
        """Warm up and capture the forward of ``st``; record its launches
        per replay and take the warm-up's and the capture's back out of
        the counts."""
        def counts():
            return _kb.snapshot(), _kb.snapshot_nhwc(), _kb.snapshot_modconv()

        def delta(a, b):
            return {k: a[k] - b[k] for k in a if a[k] != b[k]}

        before = counts()
        t0 = time.perf_counter()
        try:
            self._warm_up(st)
            mid = counts()
            # torch.cuda.graph empties the cache as it begins: read the
            # reserved memory after the same emptying
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            st.graph, st.out = self._record(st)
            after = counts()
            st.launches, st.launches_nhwc, st.modconv = (
                delta(a, m) for a, m in zip(after, mid))
        finally:
            _kb.add(*(delta(b, n) for b, n in zip(before, counts())))
        self.records.append({
            "key": [str(v) for v in key],
            "capture_s": time.perf_counter() - t0,
            "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved,
            "launches_per_replay": dict(st.launches),
            "nhwc_launches_per_replay": dict(st.launches_nhwc),
            "modconv_per_replay": dict(st.modconv)})

    def _warm_up(self, st):
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self._forward(st)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _record(self, st):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the data pipeline's threads pin and copy batches
        # while the capture runs
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = self._forward(st)
        return graph, out

    def _replay(self, st):
        st.graph.replay()
        _kb.add(st.launches, st.launches_nhwc, st.modconv)
        return st.out.clone()

    def pool_bytes(self):
        """The reserved memory the captures added, over every key."""
        return sum(r["pool_bytes"] for r in self.records)

    def release(self):
        """Drop every graph and static tensor (the pool goes with them;
        ``torch.cuda.empty_cache()`` then returns it to the device)."""
        for st in self.statics.values():
            if st.copied is not None:
                st.copied.synchronize()
            if st.graph is not None:
                st.graph.reset()
        self.statics.clear()
        self.pool = None
