"""Batch inference engine: serving of an inpainting generator on one device
or over several (port of ``shgan_tpu/serve.py``), and
:func:`generate_to_dir`, which writes an eval dataset's composites as
``<uid>.png`` for the ``--evalnog_path`` protocol.

* **fixed compiled shapes** — one captured forward per (batch,
  resolution): on one CUDA device the composite forward runs as one CUDA
  graph per batch bucket (``runtime/compiled.py``, the counterpart of the
  JAX engine's AOT-compiled forward), captured at the first batch of each
  bucket and replayed per batch; requests run in chunks of
  ``batch_size``, a ragged tail pads up to the smallest latency bucket that
  fits and the padding rows are stripped.  An engine over several devices
  runs eagerly: its blocks meet on host barriers (``ThreadGroup``), which a
  graph cannot capture; so does the pluralistic synthesis, whose ``w0``
  draw is the host's;
* **on-device postprocess** — mask-composite and uint8 quantization on the
  device (``models/infer.py``), so the readback is 1 byte per pixel; uint8
  images travel to the device as uint8;
* **asynchronous window** — ``inpaint_stream`` keeps up to ``window``
  batches queued on the device beyond the one it reads back.  On CUDA each
  queued batch carries an event recorded on its device's stream after its
  forward; its readback makes the engine's one copy stream wait on that
  event alone and copies the batch's valid rows into pinned host memory
  there, so the batches queued after it keep the device busy while it is
  copied.  The pinned block comes from torch's caching host allocator and
  is the returned array's own: the caller may keep it while later batches
  run.  The device tensor stays referenced until its copy has completed.
  On the CPU the readback is the output itself.  A batch's enqueue is a
  ``serve.batch`` span (its stages ``serve.prepare``, ``serve.z`` and the
  compiled forward's inside it) and its readback a ``serve.readback`` span
  (``runtime/tracing``; ``drained``: the newest queued batch had already
  finished as it returned, so the device had nothing queued), neither
  open while the caller runs;
* **bf16** — ``bf16=True`` runs the blocks above 16² in bfloat16 (the
  throughput configuration), on a deep copy of the model config;
* **K3** — the low-channel 3×3 convs at ≥1024² run on kernel K3
  (``ops/conv1024.takes_k3``: eligible, and no gradient recorded);
* **several devices** — ``mesh`` (a list of devices) keeps a replica of the
  generator on each; a batch is split in contiguous blocks, one a device,
  run in a thread each, and concatenated.  Each block's noise starts at its
  first row and the blocks share the style normalization's batch mean
  (:class:`~.parallel.ThreadGroup`), so the composite is the one-device
  engine's, as JAX's engine over a mesh computes.

Determinism: z is keyed by (seed, global position), identical for any
batch layout.  Random synthesis noise (``noise_mode='random'``, the serving
default) is keyed by (seed, the batch's global start, layer) and drawn at
the batch's padded shape, so it reproduces for the same layout but not
across re-batching; ``noise_mode='const'``/``'none'`` engines are layout
invariant — up to the style normalization's batch-wide mean, which padded
rows enter (``ops/modulated_conv.py``).
"""

from __future__ import annotations

import copy
import os
import os.path as osp
import threading
import timeit
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .data.rng import derive_seed
from .models.infer import composite_forward, z_for_positions
from .parallel.mesh import Rows, ThreadGroup, split
from .runtime.compiled import CompiledForward, eager_reason
from .runtime.config import model_cfg_bank
from .runtime.tracing import span

BATCH_NOISE_SALT = 0xB47C  # epoch slot of derive_seed for batch noise seeds


def resolve_device(device):
    """``None`` → the CUDA device, or raise when there is none; anything
    else is taken as given (``"cpu"`` runs the kernels' plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


def _as_model_input(images, masks):
    """Normalize user inputs to (real NCHW, mask [N,1,H,W]) numpy arrays.

    ``images``: [N,3,H,W] or [N,H,W,3]; uint8 [0,255] (kept as uint8 and
    normalized on the device) or float [-1,1] (→ float32).
    ``masks``: [N,H,W] or [N,1,H,W]; bool / {0,1}; 0 = hole, 1 = keep.
    """
    images = np.asarray(images)
    masks = np.asarray(masks)
    if images.ndim != 4:
        raise ValueError(f"images must be 4D, got {images.shape}")
    if images.shape[-1] == 3 and images.shape[1] != 3:
        images = images.transpose(0, 3, 1, 2)
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    if masks.ndim == 3:
        masks = masks[:, None]
    if masks.dtype != np.float32:
        masks = masks.astype(np.uint8)
    if images.shape[0] != masks.shape[0]:
        raise ValueError("images/masks batch mismatch")
    return np.ascontiguousarray(images), np.ascontiguousarray(masks)


class InpaintEngine:
    """Batched inpainting inference on one model, on one device or over
    several.

    Args:
        model_cfg: model-bank name (e.g. ``"shgan_g512"``) or a model cfg
            dict.
        pretrained: optional released ``.pth`` state_dict or training
            snapshot ``.pkl`` (``runtime.stages.build_generator``).
        batch_size: the batch every full chunk runs at.
        bf16: run the blocks above 16² in bfloat16 (the throughput
            configuration); the caller's cfg dict is not changed.
        noise_mode: 'random' (serving default) | 'const' | 'none'.
        seed: base seed for the weights' random init, z and noise.
        strict: load a ``.pth`` strictly (a ``.pkl`` always merges).
        latency_batches: smaller batch buckets a short tail pads up to.
        device: None = the CUDA device (raise if absent); "cpu" runs the
            plain PyTorch versions of the kernels.
        mesh: devices to split each batch over (default ``[device]``);
            every batch bucket must divide by their number.
    """

    def __init__(self, model_cfg, pretrained=None, batch_size=16,
                 bf16=False, noise_mode="random", seed=0, strict=True,
                 latency_batches=(), device=None, mesh=None):
        # runtime.stages imports this module: import it here
        from .runtime.stages import build_generator
        self.mesh = [resolve_device(d) for d in (
            mesh if mesh is not None else [device])]
        if not self.mesh:
            raise ValueError("mesh: give at least one device")
        self.device = self.mesh[0]
        if isinstance(model_cfg, str):
            model_cfg = model_cfg_bank()(model_cfg)
        if bf16:
            # a deep copy: a float32 engine built later from the caller's
            # dict stays float32
            model_cfg = copy.deepcopy(model_cfg)
            args = model_cfg["args"]
            args["encoder"]["args"]["use_fp16_before_res"] = 16
            args["synthesis"]["args"]["use_fp16_after_res"] = 16
        self.buckets = sorted({int(b) for b in latency_batches}
                              | {int(batch_size)})
        if self.buckets[0] <= 0:
            raise ValueError(f"batch buckets must be positive: {self.buckets}")
        for b in self.buckets:
            if b % len(self.mesh):
                raise ValueError(f"batch bucket {b} not divisible by "
                                 f"{len(self.mesh)} mesh devices")
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}")
        self.batch_size = int(batch_size)
        self.noise_mode = noise_mode
        self.seed = seed
        G = build_generator(model_cfg, pretrained, strict=strict, seed=seed)
        G = G.eval().requires_grad_(False)
        # one replica a device (devices named twice share it)
        self.replicas = {}
        for d in self.mesh:
            if d not in self.replicas:
                self.replicas[d] = (copy.deepcopy(G) if self.replicas
                                    else G).to(d)
        self.G = self.replicas[self.device]
        # one device: the composite forward as one CUDA graph per bucket
        # (on the CPU, the same statics run eagerly)
        self.compiled = (CompiledForward(self.G, noise_mode)
                         if len(self.mesh) == 1 else None)
        self._copy_stream = None   # made at the first CUDA readback
        self._newest = None        # the newest queued batch's event

    def path(self):
        """``"compiled"`` where a batch replays a captured graph, else
        ``"eager: <why>"`` (``runtime/compiled.eager_reason``; on the CPU
        there is nothing to capture)."""
        why = eager_reason(self.G, self.mesh)
        if why is None and self.device.type != "cuda":
            why = "on the CPU, nothing to capture"
        return "compiled" if why is None else f"eager: {why}"

    def close(self):
        """Free the captured graphs and their statics; a later batch
        captures again."""
        if self.compiled is not None:
            self.compiled.release()

    def _block(self, real, mask, z, lo, rows, noise_seed, device):
        """The composite of one block (rows ``lo...`` of the batch) on
        ``device``."""
        with torch.inference_mode():
            return composite_forward(
                self.replicas[device], torch.from_numpy(real).to(device),
                torch.from_numpy(mask).to(device),
                torch.from_numpy(z).to(device), noise_mode=self.noise_mode,
                noise_seed=noise_seed, row0=lo, rows=rows)

    def _run_padded(self, real, mask, start):
        """Queue one padded batch on the device(s); returns the uint8
        tensor on the first device without waiting for it, and the path
        it took: ``"replay"`` or ``"capture"`` of a CUDA graph, or
        ``"eager"``."""
        n = real.shape[0]
        with span("serve.z"):
            z = z_for_positions(self.seed, self.G.z_dim,
                                range(start, start + n))
        noise_seed = derive_seed(self.seed, start, BATCH_NOISE_SALT)
        w = len(self.mesh)
        if w == 1:
            if eager_reason(self.G, self.mesh) is None:
                out = self.compiled(real, mask, z, noise_seed)
                return out, self.compiled.last_path
            return self._block(real, mask, z, 0, None, noise_seed,
                               self.device), "eager"
        group = ThreadGroup(w)

        def work(k):
            lo, hi = split(n, w, k)
            try:
                return self._block(real[lo:hi], mask[lo:hi], z[lo:hi], lo,
                                   Rows(lo, hi, n, group), noise_seed,
                                   self.mesh[k])
            except BaseException:
                group.abort()   # the other blocks stop waiting
                raise

        with ThreadPoolExecutor(w) as ex:
            futs = [ex.submit(work, k) for k in range(w)]
        errs = [f.exception() for f in futs]
        first = next((e for e in errs if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errs if e is not None), None))
        if first is not None:
            raise first
        return torch.cat([f.result().to(self.device) for f in futs]), "eager"

    def _enqueue(self, images, masks, rows, start):
        """Queue one batch of ``len(images)`` rows, normalized
        (``_as_model_input``) and padded with all-kept rows up to
        ``rows``, its first row at global position ``start``; returns the
        device tensor of all ``rows`` composites and, on CUDA, the event
        after its forward on its device's stream (else None)."""
        k = len(images)
        with span("serve.batch") as s:
            with span("serve.prepare"):
                real, mask = _as_model_input(images, masks)
                if k < rows:
                    pad = [(0, rows - k)] + [(0, 0)] * 3
                    real = np.pad(real, pad)
                    mask = np.pad(mask, pad, constant_values=1)
            out, path = self._run_padded(real, mask, start)
            s.set(path=path)
            done = None
            if out.is_cuda:
                done = torch.cuda.current_stream(out.device).record_event()
            self._newest = done
        return out, done

    def _readback(self, dev, done, valid):
        """The first ``valid`` composites of a queued batch, in host memory
        the returned array owns.  On CUDA they are copied into pinned
        memory on the engine's copy stream once ``done`` (the batch's own
        event) has completed, so the batches queued after it run on."""
        with span("serve.readback") as s:
            src = dev[:valid]
            if done is None:
                out = src.cpu().numpy()
            else:
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(dev.device)
                cs = self._copy_stream
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True)
                cs.wait_event(done)
                with torch.cuda.stream(cs):
                    host.copy_(src, non_blocking=True)
                cs.record_event().synchronize()   # dev is held until here
                out = host.numpy()
            s.set(drained=self._newest is None or self._newest.query())
        return out

    def inpaint(self, images, masks, start_index=0):
        """Inpaint a batch of any size; returns uint8 NCHW composites.

        ``start_index`` positions the batch in the deterministic z stream
        (the global dataset offset).  Random noise is keyed by each chunk's
        global start and drawn at the padded shape: a ragged tail pads up
        to the smallest batch bucket that holds it."""
        n, bs = len(images), self.batch_size
        if len(masks) != n:
            raise ValueError("images/masks batch mismatch")
        if n == 0:
            return np.zeros(_as_model_input(images, masks)[0].shape,
                            np.uint8)
        outs = []
        for lo in range(0, n, bs):
            k = min(bs, n - lo)
            rows = next((b for b in self.buckets if b >= k), bs)
            queued = self._enqueue(images[lo:lo + bs], masks[lo:lo + bs],
                                   rows, start_index + lo)
            outs.append(self._readback(*queued, k))
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def inpaint_stream(self, batches, start_index=0, window=2):
        """Stream (images, masks) batches through the engine, yielding uint8
        NCHW composites per input batch, each array the caller's own; up
        to ``window`` batches stay queued on the device beyond the one
        being read back.  Every batch has ``batch_size`` rows except the
        last, which pads up to ``batch_size``."""
        inflight = []
        gi = start_index
        for images, masks in batches:
            k, bs = len(images), self.batch_size
            if k > bs:
                raise ValueError(f"stream batch {k} > engine batch {bs}")
            inflight.append((*self._enqueue(images, masks, bs, gi), k))
            gi += k
            if len(inflight) > window:
                yield self._readback(*inflight.pop(0))
        for queued in inflight:
            yield self._readback(*queued)


def generate_to_dir(engine, dataset, formatter, out_dir, log_every=10,
                    num_threads=None, log=print):
    """Run a (real, mask, uid) eval dataset through ``engine`` and write
    ``<uid>.png`` composites into ``out_dir``: the layout the ``*_loadgen``
    datasets and ``--evalnog_path`` read.  The host side is
    :class:`~.data.pipeline.EvalPipeline`, so the masks come from the same
    per-position stream as a metric run over the same dataset; padding rows
    of the last batch are not written.  Returns the number written."""
    from PIL import Image
    from .data.pipeline import EvalPipeline

    os.makedirs(out_dir, exist_ok=True)
    n, bs = len(dataset), engine.batch_size
    pipe = EvalPipeline(dataset, formatter, bs, seed=engine.seed,
                        num_threads=num_threads)
    meta = []

    def batches():
        for real, mask, valid, uids in pipe:
            meta.append((valid, uids))
            yield real, mask

    t0 = timeit.default_timer()
    written = 0
    for bi, out in enumerate(engine.inpaint_stream(batches())):
        valid, uids = meta[bi]
        for img, uid, ok in zip(out, uids, valid):
            if not ok:
                continue
            Image.fromarray(img.transpose(1, 2, 0)).save(
                osp.join(out_dir, f"{uid}.png"))
            written += 1
        if (bi + 1) % log_every == 0:
            log(f"generated {written}/{n}, "
                f"{timeit.default_timer() - t0:.2f}s")
            t0 = timeit.default_timer()
    return written
