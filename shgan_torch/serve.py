"""Batch inference engine: serving of an inpainting generator on one device
or over several (port of ``shgan_tpu/serve.py``), and
:func:`generate_to_dir`, which writes an eval dataset's composites as
``<uid>.png`` for the ``--evalnog_path`` protocol.

* **fixed batch shapes** — requests run in chunks of ``batch_size``; a
  ragged tail pads up to the smallest latency bucket that fits and the
  padding rows are stripped;
* **on-device postprocess** — mask-composite and uint8 quantization on the
  device (``models/infer.py``), so the readback is 1 byte per pixel; uint8
  images travel to the device as uint8;
* **asynchronous window** — ``inpaint_stream`` keeps up to ``window``
  batches queued on the device before it reads one back;
* **bf16** — ``bf16=True`` runs the blocks above 16² in bfloat16 (the
  throughput configuration), on a deep copy of the model config;
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
from .runtime.config import model_cfg_bank

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
        tensor on the first device without waiting for it."""
        n = real.shape[0]
        z = z_for_positions(self.seed, self.G.z_dim, range(start, start + n))
        noise_seed = derive_seed(self.seed, start, BATCH_NOISE_SALT)
        w = len(self.mesh)
        if w == 1:
            return self._block(real, mask, z, 0, None, noise_seed,
                               self.device)
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
        return torch.cat([f.result().to(self.device) for f in futs])

    def inpaint(self, images, masks, start_index=0):
        """Inpaint a batch of any size; returns uint8 NCHW composites.

        ``start_index`` positions the batch in the deterministic z stream
        (the global dataset offset).  Random noise is keyed by each chunk's
        global start and drawn at the padded shape."""
        real, mask = _as_model_input(images, masks)
        n, bs = real.shape[0], self.batch_size
        if n == 0:
            return np.zeros(real.shape, np.uint8)
        outs = []
        for lo in range(0, n, bs):
            chunk_r, chunk_m = real[lo:lo + bs], mask[lo:lo + bs]
            k = chunk_r.shape[0]
            tgt = next((b for b in self.buckets if b >= k), bs)
            if k < tgt:
                pad = [(0, tgt - k)] + [(0, 0)] * 3
                chunk_r = np.pad(chunk_r, pad)
                chunk_m = np.pad(chunk_m, pad, constant_values=1)
            out = self._run_padded(chunk_r, chunk_m, start_index + lo)
            outs.append(out[:k].cpu().numpy())
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def inpaint_stream(self, batches, start_index=0, window=2):
        """Stream (images, masks) batches through the engine, yielding uint8
        NCHW composites per input batch; up to ``window`` batches stay
        queued on the device.  Every batch has ``batch_size`` rows except
        the last."""
        inflight = []
        gi = start_index
        for images, masks in batches:
            real, mask = _as_model_input(images, masks)
            k, bs = real.shape[0], self.batch_size
            if k > bs:
                raise ValueError(f"stream batch {k} > engine batch {bs}")
            if k < bs:
                pad = [(0, bs - k)] + [(0, 0)] * 3
                real = np.pad(real, pad)
                mask = np.pad(mask, pad, constant_values=1)
            inflight.append((self._run_padded(real, mask, gi), k))
            gi += k
            if len(inflight) > window:
                dev, valid = inflight.pop(0)
                yield dev[:valid].cpu().numpy()
        for dev, valid in inflight:
            yield dev[:valid].cpu().numpy()


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
