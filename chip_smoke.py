#!/usr/bin/env python3
"""Drive the PyTorch port (shgan_torch) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py [--out perf_out]

Phases, each printing one JSON line:

1. card: the card's name and power limit (``nvidia-smi``), the kernels'
   build time (all built from ``shgan_torch/csrc`` in parallel);
2. kernels, held against their plain PyTorch versions on the same inputs
   with TF32 off (kernel, plain and library-yardstick times, each call's
   least time on the card and, for K2, its share of the HBM rate): kernel
   K2 (upfirdn2d) at every FIR call
   of a ``shgan_g512`` forward and kernel K1 (Philox noise) at every noise
   resolution, at the serving batch (8) and at batch 4; K2 and K1 at the
   1024² calls of a ``shgan_g1024`` forward at the eval batch (4); kernel
   K3 (conv3x3_lowch) at [4|1, 32, 1024, 1024] 32→32, once through
   ``_conv2d`` with ``flip_weight=False``; float32, and bfloat16 for K2
   and K3; the fused synthesis epilogue (noise_bias_act: K1's noise,
   demodulation, bias, lrelu_agc in one pass) at every synthesis layer
   shape of a ``shgan_g512`` forward at batch 8 and at the 1024² layers of
   a ``shgan_g1024`` forward at batch 4, float32 and bfloat16, its noise
   held to K1's bit for bit, beside the unfused path (K1 plus the
   PyTorch chain) on the same inputs, and its fold (the synthesis's three
   options: ``+ addend`` then one ``* scale`` output, or one or two ``*
   scale`` outputs; each on both maps, float32 and bf16, the plain launch
   plus the PyTorch chain bit for bit, float32 within the plain version's
   bound, the two that run most timed); K2 at
   the discriminator's calls of
   the training path (``comodgan_d256`` at batch 8: the blurs and the 1×1
   skips' down = 2, the resampling tiles), float32 and bf16, beside cuDNN's
   stride-2 depthwise ``conv2d``.  Every check of a kernel the compiled
   forward runs (K2 and the epilogue of the two generators, ``bias_lrelu``,
   K3) is made on both index maps: on the NCHW input and on it made
   channels-last, where the NHWC map's result stays channels-last, equals
   the NCHW map's bit for bit and is timed (``nhwc_*``; the epilogue's
   NHWC key is a noise-table row on the device, as in a replay);
3. serving path: ``InpaintEngine("shgan_g512", device="cuda",
   batch_size=8)`` with random noise (every ``noise_strength`` set to 0.1
   so the noise reaches the image), its forward one captured CUDA graph a
   batch bucket (``runtime/compiled.py``), answers requests of 8, 8 and 3 rows;
   launch counts over exactly those requests (the fused epilogue 15 a
   forward, K1 itself none), every hand-written forward launch of the
   replays on its NHWC map (the captured forward runs channels-last:
   ``nhwc_share`` 1.0); the composite contract and run-to-run
   determinism; latency and images/s;
4. parity: the same weights with constant noise at batch 1 on the card and
   on the CPU (the plain versions), uint8 composites compared;
5. eval path: ``shgan_synthetic256_eval`` assembled by the CLI's
   ``build_config`` with the model swapped to ``shgan_g1024`` (random
   weights loaded strictly from a ``.pth``), 96 synthetic 1024² images
   from a pool of 4, batch 4, K3 on the two 1024² convs (an inference
   forward's route), FID (random Inception weights from a pytorch-fid
   style ``.pth``), PSNR and SSIM,
   run by the CLI's ``run`` (its forward one captured graph, replayed a
   batch); launch counts of every kernel over exactly
   that run (K3 2, K2 24, the fused epilogue 17 a forward, K1 none), all
   of them on the NHWC maps, finite metrics in ``result.json``, images/s
   and peak memory;
6. K3 in place: one ``shgan_g1024`` batch with constant noise, TF32 off,
   on K3 and with the route's predicate patched to the library conv
   (cuDNN): composites compared, forwards timed;
7. the CLI: ``python -m shgan_torch.main --experiment
   shgan_synthetic256_eval --debug --eval 0`` exits 0 with a result.json;
8. training path: K2's backward at every K2 call of a ``shgan_g256``
   forward and a ``comodgan_d256`` forward at batch 8, and its second order
   (K2 again), against autograd of the plain version; the epilogue's grad
   kernel at every synthesis layer of ``shgan_g256`` (full mode at batch 8,
   mask-only at 4), its noise against K1's bit for bit; then
   ``shgan_ffhq256_train`` (``shgan_g256`` + ``comodgan_d256`` at full
   width, batch 8, random weights, the dataset swapped to synthetic 256²)
   assembled by ``build_config`` and run by the CLI's ``run`` for 6 steps
   (step 0 with both regularizers, 4 with the path-length penalty):
   per-step ms, images/s over steps 1–5, peak memory, launches per step
   checked against counts worked out from the modules (the counts set to 0
   as each step starts and read as it ends; none on an NHWC map), the
   modulated convs' counts per step exact (the D phase's generator
   forward, under ``no_grad``, takes the no-grad route: all but ``b4.conv``
   prescaled; Gmain and Gpl multiply in every conv), G_ema's image grids
   (``demo/fakes_init.png`` and the final one) with their own launches
   (three forwards each, none between the steps), ``stats.jsonl`` a record
   a tick keyed by ``step``, finite losses, moved weights, ``pl_mean > 0``;
   the final snapshot reloaded and one step from it equal to the same step
   from memory (cuDNN deterministic); one Gmain + Dmain + R1 gradient at
   batch 2 on the card (cuDNN deterministic) and on the CPU, TF32 off,
   each leaf within 1e-3 of its norm (the noise strengths' and the SHU's
   within 1e-2), beside the same gradient under cuDNN's default and
   autotuned algorithms; each noise strength's gradient (Σ ν·g) within
   1e-3 of the magnitude of its terms, Σ |ν·g|, on all three card runs;
9. the published eval protocol: ``shgan_ffhq256_fullmetrics_eval``
   assembled by ``build_config`` and run by ``run`` as configured
   (full-width ``shgan_g256`` with random weights from a ``.pth``, batch
   16, random noise; fid + kid + pr + is on one Inception pass a batch,
   ppl2_wend with 2000 samples on vgg16, lpips alex, psnr, ssim) on 256
   FFHQ-named 256² PNGs in ``data/ffhq/ffhq256x256.zip``, random Inception,
   AlexNet, VGG16 and LPIPS-lin weights in their released layouts reached
   through the environment variables; every metric finite, K2's launches
   by route and the epilogue's exact over the 16 stream forwards and the
   PPL forwards (K1 alone, K3 and the derivative kernels none); PPL's
   distance exactly 0 at ε = 0 with the noise on; the run again with the
   real-feature cache (fid, kid, pr within 1e-4 of their values); the
   pre-generated protocol (``--evalnog_path``, each real flipped) in
   process with no kernel launch, and through ``python -m
   shgan_torch.main`` in a subprocess;
10. training as configured: ``shgan_ffhq256_train`` assembled by
    ``build_config`` and run by ``run`` at full width (``shgan_g256`` +
    ``comodgan_d256``, batch 8, random weights, the configured loss
    kwargs) on its own ``ffhqzip`` train and val splits of an FFHQ-format
    zip it writes (64 val and 96 train PNGs), 12 steps in ticks of 3, with
    ``g_opt`` on a linear warm-up schedule (LR 0 at update 0), ``d_opt``
    the registry's Adam, a nested FID over the 64 val images every tick
    (random Inception weights) with ``-best`` snapshots, and the
    profiler's trace of steps 8–10: both optimizers' LR at every update
    bit for bit, G unmoved by update 0 and moved by update 1, launches in
    every step and outside them (two image grids and four nested evals of
    four ``shgan_g256`` forwards at batch 16, K2 by route), four finite
    ``eval_fid`` records, the run-local real-feature cache written once and
    then read (one Inception pass a batch), one ``new best`` line per
    strict improvement, the trace's ``Gmain`` / ``Dmain`` spans over 3
    steps and its top device ops; then the best G_ema exported by ``python
    -m shgan_torch.export_pth``, evaluated strictly (fid, psnr, ssim over
    the 64 val images) and loaded again from a reference-format ``.pkl``
    and from the ``.pth`` with equal composites;
11. the bf16 throughput configuration (blocks above 16² in bfloat16):
    the bf16 engine against the float32 engine on the same random weights
    and requests (noise const, the float32 reference with TF32 off) at
    ``shgan_g512`` batch 8, held to the GATE of
    ``tests/test_bf16_quality.py`` (max uint8 Δ ≤ 16, PSNR ≥ 45 dB, SSIM ≥
    0.995, fraction of Δ > 2 ≤ 0.02) beside the JAX package's TPU record,
    and at ``shgan_g1024`` batch 4 with K3 on (its bf16 route): known
    pixels exact, SSIM within the GATE, the GATE's numbers against float32
    and against the bf16 engine with K3 off recorded (set at 512², the
    GATE does not hold at 1024² with random weights); launches exact (all,
    and those on bf16 tensors), steady
    images/s of both engines in turns; ``python -m
    shgan_torch.generate --bf16`` over 64 images of an FFHQ-format zip and
    the directory scored with no generator (in process: psnr, ssim, no
    launch; ``python -m shgan_torch.main --evalnog_path``: fid);
    ``shgan_ffhq256_train`` with bf16 blocks as in phase 8 (6 steps,
    launches exact per step, bf16 ones by their own rule, the modulated
    convs' counts per step exact, a bit-exact resume); the grad kernel with bf16 I/O at the bf16 layers (both modes,
    one bf16 ulp, sums within 1e-5, noise K1's) and K2's bf16 backward at
    the resampling calls (one bf16 ulp + 1e-6) against their plain
    versions; a Gmain + Dmain + R1 gradient with bf16 blocks against the
    float32 one on the card, each leaf within twice another bf16 run's
    error; ``stylegan2_generator_256`` as configured at batch 8 (launches
    exact, card vs CPU in float32 within 1e-3, one
    ``unconditional_g_main_loss`` step with ``stylegan2_discriminator_256``:
    finite loss and gradients, w_avg moved); the phase's wall seconds;
12. several devices (``multi_device_path``): K1, the fused epilogue and its
    grad kernel (both modes, float32 and bf16) at a noise row offset of 3
    at every synthesis layer of ``shgan_g256`` on 4 rows, each element bit
    for bit the rows 3... of the launch over 7 rows (the grad kernel's plane
    sums within 1e-5 of their terms' magnitudes) and held to its plain
    version by phase 2's and 8's rules; ``shgan_ffhq256_train`` at full width
    (TF32 off) for 3 steps (Gpl and R1 in the first) and a resume for one
    more, on two rank processes (``python -c`` importing the port: both on
    ``cuda:0`` over gloo on a one-card machine, over NCCL on two cards) at
    4 rows each against this process at 8: step 0's gradients (Gpl and
    R1, second order) each network within 1e-3 or 4x the median of its
    three float32 spread samples on one card (step 0 again under cuDNN's
    autotuner and under its deterministic algorithms: each pair of the
    three runs a sample, every sample printed; every leaf's error and
    spread recorded), ``comodgan_d256`` on N(0, 1) inputs (logits, R1's
    input gradient, the Dmain and R1 weight gradients) within 1e-4,
    ``w_avg`` and ``pl_mean`` within 1e-3, the replicas equal
    bit for bit after every step, launches exact per step and rank, rank
    1's noise rows offset, the snapshot written by the lead alone; the
    eval stage over 64 images of an FFHQ-format zip (``shgan_g256``,
    random noise, fid + psnr + ssim): fid within 1e-3, the gathered
    composites by phase 4's rule, ``result.json`` written once, launches
    exact per rank; one NCCL rank alone; the engine over ``["cuda:0",
    "cuda:0"]`` at ``shgan_g512`` batch 8 against one device (phase 4's
    rule, known pixels exact); step ms, eval images/s, the ranks' start-up
    seconds and peak memory;
13. spatial (H) sharding (``shgan_torch/parallel/spatial.py``), two rank
    processes on ``cuda:0`` over gloo with a model axis of 2, TF32 off:
    the kernels' slab modes at every synthesis layer of ``shgan_g1024``
    above 4² for model axes of 2 and 4 (K1 alone, the fused epilogue and
    its grad kernel on each rank's window of plane rows, float32 and bf16,
    bit for bit those rows of the whole-plane launch, the windows' sums
    within 1e-5 of the plane's, each against its plain version by phase 2's
    and 8's rules; K3 on each halo'd slab of [1, 32, 1024²] within 1e-4 of
    the whole-plane rows); ``shgan_g1024`` b4 through the engine (random
    weights and noise, K3 on) under ``spatial_sharding(mesh, 512)``
    against one process: phase 4's uint8 rule, known pixels exact, each
    rank's launches the one process's (K3 2, K2 by route with none on the
    generic kernel, the epilogue), bytes exchanged, request ms and peak
    memory; ``shgan_ffhq256_train``'s networks at the global batch 8, 3
    ``TrainStep`` steps (Gpl and R1 in step 0) under ``spatial_sharding(
    mesh, 64)``: step 0's gradients each network within 1e-3 or 4× the
    median of its float32 spread samples on one card (phase 12's rule),
    the replicas bit for bit after every step, launches exact per step and
    rank, step ms and peak memory; then step 0 once more on the ranks with
    ``train.remat``'s networks, held to their step 0 without it by the
    same gate, its launches by the recompute rule;
14. per-block rematerialization (``train.remat``): ``shgan_ffhq256_train``'s
    networks with and without remat (the same weights, TF32 off, cuDNN
    deterministic, autotuner off), a step with Gpl and R1 and a main-only
    step each: at batch 8 every gradient, metric and weight bit for bit
    between the modes and the launches of each step exact (the recompute
    of each checkpointed block counted from the modules); at batch 32, the
    modes off, on, on, off, each step's ms by phase and its peak allocated
    and reserved memory;
15. the compiled forward (``compiled_path``): ``shgan_g512`` at batch 8
    with a latency bucket of 4, random noise, float32 and bf16, through
    the engine's graphs against the eager ``composite_forward`` on the
    same inputs in the same channels-last layout: five requests at other
    starts, a 3-row request through bucket 4 and ``inpaint_stream`` at
    ``window=2`` (each bit for bit or by phase 4's rule, the gap printed;
    known pixels exact; two starts differ; launches exact per forward over
    the replays; the modulated convs' counts, prescaled by the epilogue's
    fold or multiplied, exact per replay); in float32 the same requests
    against the NCHW eager
    forward too, within the ``g512-stream-b8`` cell's limits (known pixels
    exact, the figures printed); ``shgan_g1024``
    at batch 4 with K3 through the eval stage over 96 images, compiled and
    eager (composites by the same rule, fid / psnr / ssim equal, launches
    exact); request ms at 8 and 3 rows, steady images/s and the host's
    enqueue ms of both, capture seconds per key, pool GiB, eval images/s
    of both, beside the card's name and power limit;
16. the kernels line ``{"kernels": [...]}`` (a forward kernel's ``ms``,
    ``bf16_ms`` and ``max_abs_err`` from its NHWC map, which the compiled
    forward runs, and ``nchw_*`` from its NCHW map, which the eager paths
    and training run; the grad kernel's and K2
    backward's rows with their bf16 numbers; every row's launches over
    phase 11 as ``launches_bf16_path``, over phase 12 as
    ``launches_multi_device_path``, over phase 13 as
    ``launches_spatial_path``, over phase 14 as
    ``launches_remat_path`` and over phase 15 as
    ``launches_compiled_path``);
17. last line: ``{"ok": true, "device": {...}}``.

A one-device engine and a one-rank eval replay one graph a batch shape;
the launch counts of a replay are the capture's (``runtime/compiled.py``),
and the script's own tallies (K2 by route, launches on bf16 tensors) count
replays by the same rule (``graph_tallies``).

Any failed check raises: the script then exits non-zero and prints no
result line.  It needs the repository (``shgan_torch``, ``configs/``) and
imports nothing of JAX.  Per-call details go to ``<out>/chip_smoke_detail.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
import torch.nn.functional as F

MODEL = "shgan_g512"
SERVE_BATCH = 8
MODEL_1024 = "shgan_g1024"   # the eval path: its 1024² level runs K3
EVAL_BATCH = 4
EVAL_IMAGES = 96    # the eval run as the CLI runs it: 24 batches, pool of 4
K3_RES = 1024
K3_F32_ATOL = 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12   # H100 SXM bfloat16 tensor cores, dense
FIR_F32_ATOL = 1e-5
NOISE_ATOL = 1e-4
CL = torch.channels_last
# the serving cells' limits of a composite against the plain reference
# (PERF.md §2): % of hole values > 1 level off, and their RMS gap in levels
CELL_LIMITS = {"shgan_g512": (2.5, 0.8), "shgan_g1024": (4.5, 0.9)}
TRAIN_EXPERIMENT = "shgan_ffhq256_train"   # shgan_g256 + comodgan_d256
TRAIN_G, TRAIN_D = "shgan_g256", "comodgan_d256"
TRAIN_BATCH = 8
TRAIN_STEPS = 6   # step 0 both regularizers, 4 the path length, others main
GRID_FORWARDS = 3   # an 8 x 6 image grid in forwards of 16 (draw_demo_grid)
PARITY_BATCH = 2


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries ``at_s``, the seconds since the
    script started, so a slow phase shows where its time went."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def eager_ms(fn, iters):
    """Mean time per call of ``fn`` over ``iters`` back-to-back eager calls,
    between two CUDA events: the device time, or the host's launch time
    where that is longer."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, nbytes):
    """Device time per call of ``fn``: calls captured in one CUDA graph and
    replayed, so the host's launch cost drops out.  Small calls find their
    inputs in the 50 MB L2 cache."""
    n = int(min(100, max(3, 1e9 / max(nbytes, 1))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph
    torch.cuda.empty_cache()
    return ms


def cpu_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def iters_for(nbytes):
    return int(min(200, max(10, 2e9 / max(nbytes, 1))))


def fir_calls(cfg, batch):
    """Every upfirdn2d call of one generator forward at ``batch``: (site,
    resolution, input shape, up, down, pads, gain).  Taps are [1,3,3,1]."""
    enc, syn = cfg["args"]["encoder"]["args"], cfg["args"]["synthesis"]["args"]
    res = int(enc["resolution"])
    ch = lambda base, r: min(int(base) // r, int(enc["ch_max"]))  # noqa: E731
    calls = []
    r = res
    while r > 4:   # encoder conv1 (down=2): blur with pad 2, then stride 2
        calls.append(("enc_down_blur", r, (batch, ch(enc["ch_base"], r), r, r),
                      1, 1, (2, 2, 2, 2), 1))
        r //= 2
    r = 8
    while r <= res:
        c = min(int(syn["ch_base"]) // r, int(syn["ch_max"]))
        # synthesis conv0 (up=2): transposed conv to R+1, FIR with pad 1
        calls.append(("syn_up_fir", r, (batch, c, r + 1, r + 1), 1, 1,
                      (1, 1, 1, 1), 4))
        # skip-image upsample2d: up=2, pads (2, 1)
        calls.append(("img_upsample", r, (batch, 3, r // 2, r // 2), 2, 1,
                      (2, 1, 2, 1), 4))
        r *= 2
    return calls


def noise_layers(cfg):
    """{resolution: noise layers at it} of one synthesis forward."""
    res = int(cfg["args"]["synthesis"]["args"]["resolution"])
    out, r = {4: 1}, 8
    while r <= res:
        out[r] = 2
        r *= 2
    return out


def bound(row, nbytes, ops, flops_per_s=FP32_FLOPS_PER_S):
    """The least time for the call: its bytes over the memory rate or its
    operations over ``flops_per_s`` (the fastest rate the card has for
    them), whichever is larger."""
    row["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["ops_ms"] = ops / flops_per_s * 1e3
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                       else "operations")


def bound_by(rows):
    by = {r["bound_by"] for r in rows}
    return by.pop() if len(by) == 1 else "bytes and operations"


def bf16_ulp(v):
    return 2.0 ** (torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def nhwc_map(kern, x, y_nchw, want, what, nbytes):
    """A forward kernel's NHWC map, which the compiled forward runs: ``kern``
    (a function of its input) on ``x`` made channels-last.  Its result is
    channels-last and bit for bit ``y_nchw``, the NCHW map's on ``x``.
    Returns (its max |error| against the plain version's ``want``, its
    device ms)."""
    xl = x.contiguous(memory_format=CL)
    yl = kern(xl.clone())
    torch.cuda.synchronize()
    if not yl.is_contiguous(memory_format=CL):
        raise AssertionError(f"{what}: the NHWC map's result is not "
                             f"channels-last")
    if not torch.equal(yl, y_nchw):
        d = float((yl.float() - y_nchw.float()).abs().max())
        raise AssertionError(f"{what}: the NHWC map differs from the NCHW "
                             f"map by up to {d}")
    err = float((yl.float() - want.float()).abs().max())
    return err, graph_ms(lambda: kern(xl), nbytes)


def check_fir(fir, calls, dtype_list, cpu_plain=True, nhwc=True):
    """K2 against its plain version at each of ``calls`` (``fir_calls``
    or ``train_fir_calls`` rows); with ``nhwc``, its NHWC map too
    (``nhwc_map``: the ``nhwc_*`` figures), as the compiled forward runs
    it."""
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]), gain=1)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(calls[0][2][0])
    for site, r, shape, up, down, pads, gain in calls:
        t = taps * gain
        x = torch.randn(shape, generator=gen, device="cuda")
        ups, downs = (up, up), (down, down)
        y = fir.fir_cuda(x, t, ups, downs, pads)
        want = fir.fir_plain(x, t, ups, downs, pads)
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        if not err <= FIR_F32_ATOL:
            raise AssertionError(f"K2 f32 {site} R={r} {shape}: {err}")
        row = {"site": site, "res": r, "shape": list(shape), "up": up,
               "down": down, "pads": list(pads), "max_abs_err": err,
               "out_shape": list(y.shape)}
        nbytes = (x.numel() + y.numel()) * 4
        row["iters"] = iters_for(nbytes)
        kern = lambda: fir.fir_cuda(x, t, ups, downs, pads)  # noqa: E731
        row["ms"] = graph_ms(kern, nbytes)
        row["eager_ms"] = eager_ms(kern, row["iters"])
        row["plain_ms"] = eager_ms(
            lambda: fir.fir_plain(x, t, ups, downs, pads), row["iters"])
        # yardstick: one PyTorch call computing the same function
        c = shape[1]
        w = torch.as_tensor(np.array(t), device="cuda")[None, None].expand(
            c, 1, *t.shape).contiguous()
        if up == 1:   # (down = 2: a stride-2 depthwise conv)
            lib = lambda: F.conv2d(x, w, stride=down, padding=pads[0],  # noqa
                                   groups=c)
        else:   # zero-insert + pad (2, 1) + taps == stride-2 transposed conv
            wt = w.flip([2, 3]).contiguous()
            lib = lambda: F.conv_transpose2d(x, wt, stride=2, padding=1,  # noqa
                                             groups=c)
        lib_err = float((lib() - want).abs().max())
        if not lib_err <= FIR_F32_ATOL:
            raise AssertionError(f"library yardstick disagrees: {lib_err}")
        row["library_ms"] = graph_ms(lib, nbytes)
        row["library_eager_ms"] = eager_ms(lib, row["iters"])
        nz = t.size // (up * up)          # taps that meet a sample
        bound(row, nbytes, 2 * y.numel() * nz)
        row["hbm_share"] = row["bytes_ms"] / row["ms"]   # of 3.35 TB/s
        kern_of = lambda v: fir.fir_cuda(v, t, ups, downs, pads)  # noqa
        if nhwc:
            row["nhwc_max_abs_err"], row["nhwc_ms"] = nhwc_map(
                kern_of, x, y, want, f"K2 f32 {site} R={r}", nbytes)
            row["nhwc_hbm_share"] = row["bytes_ms"] / row["nhwc_ms"]
        if cpu_plain:
            xc = x.cpu()
            row["plain_cpu_ms"] = cpu_ms(
                lambda: fir.fir_plain(xc, t, ups, downs, pads))
        if torch.bfloat16 in dtype_list:
            xb = x.bfloat16()
            yb = fir.fir_cuda(xb, t, ups, downs, pads)
            wb = fir.fir_plain(xb.float(), t, ups, downs, pads)
            torch.cuda.synchronize()
            d = (yb.float() - wb).abs()
            if not bool((d <= bf16_ulp(wb) + 1e-6).all()):
                raise AssertionError(f"K2 bf16 {site} R={r}: {float(d.max())}")
            row["bf16_max_abs_err"] = float(d.max())
            row["bf16_ms"] = graph_ms(
                lambda: fir.fir_cuda(xb, t, ups, downs, pads), nbytes // 2)
            row["bf16_bound_ms"] = (xb.numel() + yb.numel()) * 2 \
                / HBM_BYTES_PER_S * 1e3
            row["bf16_hbm_share"] = row["bf16_bound_ms"] / row["bf16_ms"]
            if nhwc:
                row["nhwc_bf16_max_abs_err"], row["nhwc_bf16_ms"] = nhwc_map(
                    kern_of, xb, yb, wb, f"K2 bf16 {site} R={r}", nbytes // 2)
        rows.append(row)
    return rows


def check_noise(noise, batch, layers, cpu_plain=True):
    """K1 against its plain version at every noise resolution."""
    rows = []
    for r in sorted(layers):
        key = noise.noise_key(1234, 2 * r)
        y = noise.philox_normal_cuda(key, batch, r, "cuda")
        want = noise.philox_normal_plain(key, batch, r, "cuda")
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        if not err <= NOISE_ATOL:
            raise AssertionError(f"K1 R={r}: {err}")
        n = batch * r * r
        it = iters_for(4 * n)
        kern = lambda: noise.philox_normal_cuda(key, batch, r, "cuda")  # noqa
        lib = lambda: torch.randn((batch, 1, r, r), device="cuda")  # noqa
        row = {"res": r, "batch": batch, "layers_per_forward": layers[r],
               "max_abs_err": err, "iters": it,
               "ms": graph_ms(kern, 4 * n),
               "eager_ms": eager_ms(kern, it),
               "plain_ms": eager_ms(lambda: noise.philox_normal_plain(
                   key, batch, r, "cuda"), it),
               "library_ms": graph_ms(lib, 4 * n),
               "library_eager_ms": eager_ms(lib, it)}
        if cpu_plain:
            row["plain_cpu_ms"] = cpu_ms(lambda: noise.philox_normal_plain(
                key, batch, r, "cpu"))
        # per 4 normals: 10 rounds of 2 mul-hi/lo + 4 xor + 2 key adds;
        # 2 x (log, sqrt, sincos, ~8 float ops) -> ~160 operations
        bound(row, 4 * n, n / 4 * 160)
        rows.append(row)
    return rows


def epilogue_layers(cfg):
    """{(resolution, channels): synthesis layers at it} of one forward."""
    syn = cfg["args"]["synthesis"]["args"]
    ch = lambda r: min(int(syn["ch_base"]) // r, int(syn["ch_max"]))  # noqa
    return {(r, ch(r)): k for r, k in noise_layers(cfg).items()}


def unfused_chain(noise, x, d, b, act, strength, seed, layer):
    """The unfused path after the conv: kernel K1 draws the noise, then
    the PyTorch chain scales it, adds it with the dcoefs (addcmul), adds
    the bias and runs lrelu_agc."""
    from shgan_torch.ops.bias_act import lrelu_agc
    n, _, r, _ = x.shape
    ns = noise.random_noise(seed, layer, n, r, x.device) * strength
    y = torch.addcmul(ns.to(x.dtype), x, d.to(x.dtype)[:, :, None, None])
    y = y + b.to(x.dtype)[None, :, None, None]
    return lrelu_agc(y, act[0], gain=act[1], clamp=act[2])


def check_epilogue(noise, nba, cfg, batch, layers=None, seed=1234):
    """The fused epilogue against its plain version at each synthesis layer
    shape (random noise, demodulation, bias, the config's lrelu_agc), its
    noise against K1's bit for bit, and the unfused path (K1 + the PyTorch
    chain) timed on the same inputs; its NHWC map (``nhwc_map``, the
    ``nhwc_*`` figures) with the noise keyed by a noise-table row on the
    device, as the compiled forward runs it, its noise K1's too."""
    from shgan_torch.ops.bias_act import parse_activation
    spec = cfg["args"]["synthesis"]["args"].get(
        "activation", "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")
    act = nba.epilogue_act(parse_activation(spec))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(batch)
    for (r, c), count in sorted((layers or epilogue_layers(cfg)).items()):
        layer = 2 * r
        key = noise.noise_key(seed, layer)
        x = torch.randn((batch, c, r, r), generator=gen, device="cuda")
        d = torch.rand((batch, c), generator=gen, device="cuda") + 0.5
        b = torch.randn((c,), generator=gen, device="cuda") * 0.1
        s = torch.full((), 0.1, device="cuda")
        noise_tol = NOISE_ATOL * float(s) * act[1]
        kw = dict(dcoefs=d, bias=b, act=act, noise_mode="random",
                  noise_key=key, strength=s)
        want = nba.noise_bias_act_plain(x, **kw)
        y = nba.noise_bias_act_cuda(x.clone(), **kw)
        zero = nba.noise_bias_act_cuda(
            torch.zeros_like(x), d, noise_mode="random", noise_key=key,
            strength=torch.ones((), device="cuda"))
        k1 = noise.philox_normal_cuda(key, batch, r, "cuda")[:, None]
        torch.cuda.synchronize()
        if not torch.equal(zero, k1.expand_as(zero)):
            raise AssertionError(f"fused noise != K1 at R={r}")
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 23)
        tol = 4 * ulp + noise_tol
        err = float((y - want).abs().max())
        if not bool(((y - want).abs() <= tol).all()):
            raise AssertionError(f"noise_bias_act f32 R={r} C={c}: {err}")
        nbytes = 2 * x.numel() * 4 + (d.numel() + b.numel() + 1) * 4
        it = iters_for(nbytes)
        xk = x.clone()
        kern = lambda: nba.noise_bias_act_cuda(xk, **kw)  # noqa: E731
        lib = lambda: unfused_chain(noise, x, d, b, act, s, seed,  # noqa
                                   layer)
        lib_d = (lib() - want).abs()
        if not bool((lib_d <= tol).all()):
            raise AssertionError(f"unfused path disagrees: "
                                 f"{float(lib_d.max())}")
        row = {"res": r, "channels": c, "batch": batch,
               "layers_per_forward": count, "max_abs_err": err,
               "noise_equals_k1": True, "iters": it,
               "ms": graph_ms(kern, nbytes), "eager_ms": eager_ms(kern, it),
               "plain_ms": eager_ms(lambda: nba.noise_bias_act_plain(
                   x, **kw), 3),
               "library_ms": graph_ms(lib, nbytes),
               "library_eager_ms": eager_ms(lib, it)}
        # x read once and written once; the normals (~65 operations each,
        # once per pixel) and ~8 operations an element
        bound(row, nbytes, batch * r * r * 65 + x.numel() * 8)
        row["hbm_share"] = row["bytes_ms"] / row["ms"]
        # the NHWC map reads its key from a table row, as a replay does
        kw_row = dict(kw, noise_key=torch.tensor(
            [*key, 0], dtype=torch.int64, device="cuda"))
        kern_of = lambda v: nba.noise_bias_act_cuda(v, **kw_row)  # noqa
        row["nhwc_max_abs_err"], row["nhwc_ms"] = nhwc_map(
            kern_of, x, y, want, f"noise_bias_act f32 R={r} C={c}", nbytes)
        row["nhwc_hbm_share"] = row["bytes_ms"] / row["nhwc_ms"]
        zl = nba.noise_bias_act_cuda(
            torch.zeros_like(x, memory_format=CL), d, noise_mode="random",
            noise_key=kw_row["noise_key"],
            strength=torch.ones((), device="cuda"))
        torch.cuda.synchronize()
        if not torch.equal(zl, k1.expand_as(zl)):
            raise AssertionError(f"fused noise (NHWC) != K1 at R={r}")
        xb = x.bfloat16()
        yb = nba.noise_bias_act_cuda(xb.clone(), **kw)
        wb = nba.noise_bias_act_plain(xb.float(), **kw)
        torch.cuda.synchronize()
        db = (yb.float() - wb).abs()
        if not bool((db <= bf16_ulp(wb) + noise_tol).all()):
            raise AssertionError(f"noise_bias_act bf16 R={r}: "
                                 f"{float(db.max())}")
        row["bf16_max_abs_err"] = float(db.max())
        xbk = xb.clone()
        bf16_bytes = nbytes - 2 * x.numel() * 2
        row["bf16_ms"] = graph_ms(lambda: nba.noise_bias_act_cuda(xbk, **kw),
                                  bf16_bytes)
        row["bf16_hbm_share"] = bf16_bytes / HBM_BYTES_PER_S * 1e3 \
            / row["bf16_ms"]
        row["nhwc_bf16_max_abs_err"], row["nhwc_bf16_ms"] = nhwc_map(
            kern_of, xb, yb, wb, f"noise_bias_act bf16 R={r} C={c}",
            bf16_bytes)
        row.update(check_fold(nba, x, kw, kw_row, want,
                              f"noise_bias_act fold R={r} C={c}"))
        rows.append(row)
        del x, xk, xb, xbk, y, yb, want, wb, zero, zl, k1
        torch.cuda.empty_cache()
    return rows


# the fold's options the synthesis runs: a conv0 (the skip, conv1's input),
# a conv1 before another block (torgb's and the next conv0's inputs), the
# last conv1 (torgb's)
FOLD_OPTIONS = {"add_1": (True, 1), "out_2": (False, 2), "out_1": (False, 1)}


def check_fold(nba, x, kw, kw_row, want, what):
    """The fold (the epilogue writing its consumers' inputs: ``+ addend``,
    then ``* scale`` for up to two consumers) at ``x``'s shape, each option
    the synthesis runs (:data:`FOLD_OPTIONS`) on both maps (the NHWC map keyed by ``kw_row``'s table row), float32
    and bf16: its outputs are the plain launch's followed by the chain it
    replaces (``+ addend``, ``* scale.to(x.dtype)``) bit for bit, and in
    float32 within the plain version's bound of ``noise_bias_act_plain``
    with the fold (the epilogue's bound ``want`` carried through the add
    and the product, one rounding each).  The NHWC float32 launches of the
    two options that run most (``add_1``: a conv0; ``out_2``: a conv1
    before another block) are timed.  Returns the row's fold fields."""
    n, c = x.shape[:2]
    gen = torch.Generator(device="cuda").manual_seed(c + 1)
    scales = tuple(torch.rand((n, c), generator=gen, device="cuda") + 0.5
                   for _ in range(2))
    addend = torch.randn(x.shape, generator=gen, device="cuda") * 0.5
    ulp = lambda t: 2.0 ** (torch.floor(torch.log2(  # noqa: E731
        t.abs().clamp_min(1e-30))) - 23)
    noise_tol = NOISE_ATOL * float(kw["strength"]) * kw["act"][1]
    pre_tol = 4 * ulp(want) + noise_tol
    err, out = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for fmt in (torch.contiguous_format, CL):
            k = kw_row if fmt is CL else kw
            xd = x.to(dtype).contiguous(memory_format=fmt)
            ad = addend.to(dtype).contiguous(memory_format=fmt)
            ref = nba.noise_bias_act_cuda(xd.clone(), **k)
            for name, (add, outs) in FOLD_OPTIONS.items():
                sc = scales[:outs]
                got = nba.noise_bias_act_cuda(
                    xd.clone(), addend=ad if add else None, scales=sc, **k)
                got = got if outs else (got,)
                chain = ref + ad if add else ref
                chain = [chain * t.to(dtype)[:, :, None, None]
                         for t in sc] or [chain]
                torch.cuda.synchronize()
                for g_, w_ in zip(got, chain):
                    if (not torch.equal(g_, w_)
                            or g_.is_contiguous(memory_format=CL)
                            != (fmt is CL)):
                        raise AssertionError(f"{what} {name} {dtype} {fmt}: "
                                             f"not the chain's bits")
                if dtype is not torch.float32 or fmt is CL:
                    continue
                plain = nba.noise_bias_act_plain(
                    x, addend=addend if add else None, scales=sc, **kw)
                plain = plain if outs else (plain,)
                s_pre = want + addend if add else want
                for g_, p_, t in zip(got, plain, sc or (None,)):
                    m = 1.0 if t is None else t[:, :, None, None]
                    tol = (pre_tol + (ulp(s_pre) if add else 0)) * m \
                        + ulp(p_)
                    d = (g_ - p_).abs()
                    if not bool((d <= tol).all()):
                        raise AssertionError(f"{what} {name}: "
                                             f"{float(d.max())} from plain")
                    err = max(err, float(d.max()))
    xl = x.contiguous(memory_format=CL)
    al = addend.contiguous(memory_format=CL)
    plane = x.numel() * 4
    out["fold_max_abs_err"] = err
    out["fold_bit_for_bit"] = True
    out["fold_nhwc_ms"] = {
        "add_1": graph_ms(lambda: nba.noise_bias_act_cuda(
            xl, addend=al, scales=scales[:1], **kw_row), 3 * plane),
        "out_2": graph_ms(lambda: nba.noise_bias_act_cuda(
            xl, scales=scales, **kw_row), 3 * plane)}
    return out


def encoder_conv_layers(cfg):
    """{(resolution, channels): the encoder's Conv2dLayers whose output is
    that} of one forward: fromrgb at R, conv0 (ch(r) at r²) and conv1
    (ch(r/2) at (r/2)²) for each level r from R down to 8, and the 4²
    epilogue's conv; each ends in its bias and lrelu_agc (bias_lrelu)."""
    enc = cfg["args"]["encoder"]["args"]
    ch = lambda r: min(int(enc["ch_base"]) // r, int(enc["ch_max"]))  # noqa
    res = int(enc["resolution"])
    sites = [res]
    r = res
    while r >= 8:
        sites += [r, r // 2]
        r //= 2
    sites.append(4)
    out = {}
    for r in sites:
        out[(r, ch(r))] = out.get((r, ch(r)), 0) + 1
    return out


def conv_chain(x, b, act):
    """A conv layer's bias and activation as it ran before bias_lrelu: the
    bias add, then lrelu_agc as PyTorch ops."""
    from shgan_torch.ops.bias_act import lrelu_agc
    return lrelu_agc(x + b.to(x.dtype)[None, :, None, None], act[0],
                     gain=act[1], clamp=act[2])


def check_conv_epilogue(nba, cfg, batch, layers=None):
    """bias_lrelu (a conv layer's bias and activation in one launch) at each
    of the encoder's conv output shapes: in place, float32 bit for bit the
    PyTorch chain, bf16 the float32 chain on the widened input rounded once;
    timed beside the chain on the same input; its NHWC map too
    (``nhwc_map``, the ``nhwc_*`` figures), as the compiled forward runs
    it."""
    from shgan_torch.ops.bias_act import parse_activation
    spec = cfg["args"]["encoder"]["args"].get(
        "activation", "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")
    act = nba.epilogue_act(parse_activation(spec))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(batch + 1)
    for (r, c), count in sorted((layers or encoder_conv_layers(cfg)).items()):
        x = torch.randn((batch, c, r, r), generator=gen, device="cuda") * 100
        b = torch.randn((c,), generator=gen, device="cuda") * 0.1
        want = conv_chain(x, b, act)
        y = nba.noise_bias_act_cuda(x.clone(), None, b, act)
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"bias_lrelu f32 R={r} C={c}: "
                                 f"{float((y - want).abs().max())}")
        nbytes = 2 * x.numel() * 4 + c * 4
        it = iters_for(nbytes)
        xk = x.clone()
        kern = lambda: nba.noise_bias_act_cuda(xk, None, b, act)  # noqa
        lib = lambda: conv_chain(x, b, act)  # noqa: E731
        row = {"res": r, "channels": c, "batch": batch,
               "layers_per_forward": count, "iters": it, "max_abs_err": 0.0,
               "ms": graph_ms(kern, nbytes), "eager_ms": eager_ms(kern, it),
               "library_ms": graph_ms(lib, nbytes),
               "library_eager_ms": eager_ms(lib, it)}
        # x read once and written once; ~6 operations an element
        bound(row, nbytes, x.numel() * 6)
        row["hbm_share"] = row["bytes_ms"] / row["ms"]
        kern_of = lambda v: nba.noise_bias_act_cuda(v, None, b, act)  # noqa
        row["nhwc_max_abs_err"], row["nhwc_ms"] = nhwc_map(
            kern_of, x, y, want, f"bias_lrelu f32 R={r} C={c}", nbytes)
        row["nhwc_hbm_share"] = row["bytes_ms"] / row["nhwc_ms"]
        xb = x.bfloat16()
        yb = nba.noise_bias_act_cuda(xb.clone(), None, b, act)
        wb = conv_chain(xb.float(), b, act).bfloat16()
        torch.cuda.synchronize()
        if not torch.equal(yb, wb):
            err = float((yb.float() - wb.float()).abs().max())
            raise AssertionError(f"bias_lrelu bf16 R={r} C={c}: {err}")
        xbk = xb.clone()
        bf16_bytes = nbytes - 2 * x.numel() * 2
        row["bf16_ms"] = graph_ms(
            lambda: nba.noise_bias_act_cuda(xbk, None, b, act), bf16_bytes)
        row["bf16_hbm_share"] = bf16_bytes / HBM_BYTES_PER_S * 1e3 \
            / row["bf16_ms"]
        row["nhwc_bf16_max_abs_err"], row["nhwc_bf16_ms"] = nhwc_map(
            kern_of, xb, yb, wb, f"bias_lrelu bf16 R={r} C={c}", bf16_bytes)
        rows.append(row)
        del x, xk, xb, xbk, y, yb, want, wb
        torch.cuda.empty_cache()
    return rows


def quantized(imgs_u8):
    """The composite protocol's round trip of a kept uint8 pixel."""
    real = torch.from_numpy(imgs_u8).float() / 127.5 - 1.0
    return torch.clamp(real * 127.5 + 127.5, 0, 255).to(torch.uint8).numpy()


def requests(res, seed):
    rng = np.random.RandomState(seed)
    out = []
    for n in (8, 8, 3):
        imgs = rng.randint(0, 256, (n, 3, res, res), dtype=np.uint8)
        masks = (rng.rand(n, res, res) > 0.5).astype(np.float32)
        out.append((imgs, masks))
    return out


def check_conv3(conv1024, conv_resample):
    """K3 against its plain version at the shape of the two eligible convs
    of a ``shgan_g1024`` forward at the eval batch (and at batch 1), one
    case routed through ``_conv2d`` with ``flip_weight=False``; float32 and
    bfloat16; each on its NHWC map too (``nhwc_map``, the ``nhwc_*``
    figures), as the compiled forward runs it.  TF32 is off, except where a
    row says so."""
    from shgan_torch.kernels import build
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    c = o = 32
    for n, flip in ((EVAL_BATCH, False), (1, False), (EVAL_BATCH, True)):
        shape = (n, c, K3_RES, K3_RES)
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn((o, c, 3, 3), generator=gen, device="cuda") \
            / math.sqrt(9 * c)
        wc = w.flip([2, 3]) if flip else w   # the correlation kernel
        before = build.launches["conv3x3_lowch"]
        if flip:   # the routing of ops/conv_resample._conv2d, in inference
            with torch.inference_mode():
                y = conv_resample._conv2d(x, w, padding=(1, 1),
                                          flip_weight=False)
        else:
            y = conv1024.conv3x3_lowch(x, w)
        if build.launches["conv3x3_lowch"] != before + 1:
            raise AssertionError("K3 was not launched")
        want = conv1024.conv3x3_lowch_plain(x, wc)
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        if not err <= K3_F32_ATOL:
            raise AssertionError(f"K3 f32 {shape} flip={flip}: {err}")
        lib = lambda: F.conv2d(x, wc, padding=1)  # noqa: E731
        lib_err = float((lib() - want).abs().max())
        if not lib_err <= K3_F32_ATOL:
            raise AssertionError(f"library yardstick disagrees: {lib_err}")
        nbytes = (x.numel() + y.numel() + wc.numel()) * 4
        it = iters_for(nbytes)
        kern = lambda: conv1024.conv3x3_lowch(x, wc)  # noqa: E731
        row = {"shape": list(shape), "out_channels": o,
               "flip_weight": not flip, "max_abs_err": err,
               "library_max_abs_err": lib_err, "iters": it,
               "ms": graph_ms(kern, nbytes), "eager_ms": eager_ms(kern, it),
               "plain_ms": eager_ms(
                   lambda: conv1024.conv3x3_lowch_plain(x, wc), 3),
               "library_ms": graph_ms(lib, nbytes),
               "library_eager_ms": eager_ms(lib, it)}
        torch.backends.cudnn.allow_tf32 = True
        row["library_tf32_ms"] = graph_ms(lib, nbytes)
        torch.backends.cudnn.allow_tf32 = False
        row["ops"] = 2 * n * K3_RES * K3_RES * 9 * c * o
        # a float32 conv's least time: its operations at the dense TF32
        # tensor-core rate (not the 67 TF/s outside the tensor cores)
        bound(row, nbytes, row["ops"], TF32_FLOPS_PER_S)
        # K3 keeps float32 accuracy with three TF32 products per
        # multiply-add (3xTF32): the floor of that design, not a bound
        row["floor_3xtf32_ms"] = 3 * row["ops"] / TF32_FLOPS_PER_S * 1e3
        row["nhwc_max_abs_err"], row["nhwc_ms"] = nhwc_map(
            lambda v: conv1024.conv3x3_lowch(v, wc), x, y, want,
            f"K3 f32 {shape}", nbytes)
        if not flip:
            xb = x.bfloat16()
            yb = conv1024.conv3x3_lowch(xb, wc)
            # the plain version in float32 on the bf16 input, with the
            # weights rounded to bf16 as the wrapper hands them to K3
            wb = conv1024.conv3x3_lowch_plain(xb.float(), wc.bfloat16().float())
            torch.cuda.synchronize()
            d = (yb.float() - wb).abs()
            if not bool((d <= bf16_ulp(wb) + 1e-6).all()):
                raise AssertionError(f"K3 bf16 {shape}: {float(d.max())}")
            nb = nbytes // 2
            row["bf16_max_abs_err"] = float(d.max())
            row["bf16_ms"] = graph_ms(
                lambda: conv1024.conv3x3_lowch(xb, wc), nb)
            row["bf16_library_ms"] = graph_ms(
                lambda: F.conv2d(xb, wc.bfloat16(), padding=1), nb)
            # the function's bound in bfloat16: its operations at the dense
            # bf16 tensor-core rate, not at K3's float32 FMA rate
            bf16_bytes_ms = nb / HBM_BYTES_PER_S * 1e3
            bf16_ops_ms = row["ops"] / BF16_FLOPS_PER_S * 1e3
            row["bf16_bound_ms"] = max(bf16_bytes_ms, bf16_ops_ms)
            row["bf16_bound_by"] = ("bytes" if bf16_bytes_ms >= bf16_ops_ms
                                    else "operations")
            row["nhwc_bf16_max_abs_err"], row["nhwc_bf16_ms"] = nhwc_map(
                lambda v: conv1024.conv3x3_lowch(v, wc), xb, yb, wb,
                f"K3 bf16 {shape}", nb)
        rows.append(row)
        del x, y, want
        torch.cuda.empty_cache()
    return rows


def noise_reaches_image(G):
    """Random weights keep every ``noise_strength`` at 0: set it to 0.1 so
    the noise reaches the image."""
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)


def random_weights(model, path, seed=0):
    """Random full-width weights, noise on, saved as a released-style
    ``.pth``."""
    from shgan_torch.models.registry import get_model
    from shgan_torch.runtime.config import model_cfg_bank
    G = get_model(model_cfg_bank()(model), seed=seed)
    noise_reaches_image(G)
    torch.save(G.state_dict(), path)


def eval_config(tmp, g_pth, inc_pth, images, log_sub):
    """``shgan_synthetic256_eval`` through the CLI's config assembly, with
    the model swapped to ``shgan_g1024`` and ``images`` synthetic 1024²
    images."""
    from shgan_torch.main import build_config
    cfg = build_config("shgan_synthetic256_eval", eval_id=0,
                       model=MODEL_1024, eval_tag="g1024",
                       pretrained=g_pth, log_root=os.path.join(tmp, log_sub))
    ev = cfg["eval"]
    ev["dataset"] = {
        "type": "synthetic", "name": "synthetic1024_inpainting",
        "args": {"resolution": K3_RES, "length": images, "pool": 4,
                 "seed": 0},
        "formatter": {"type": "RandomMaskFormatter",
                      "args": {"random_flip": False,
                               "mask_resolution": K3_RES,
                               "hole_range": [0, 1]}}}
    ev.update(batch_size=EVAL_BATCH, dataset_num_workers=4,
              noise_mode="random",
              output_sample_images=False, log_display=images,
              evaluator=[{"type": "fid",
                          "args": {"detector_weights": inc_pth}},
                         {"type": "psnr", "args": {"for_dataset": None,
                                                   "rgb_range": 1}},
                         {"type": "ssim", "args": {"window_size": 11}}])
    return cfg


def k3_in_place(cfg, g_pth):
    """One ``shgan_g1024`` batch with constant noise, TF32 off: the forward
    on K3 and on the library conv (cuDNN, :func:`library_conv`), composites
    compared and both forwards timed, in turns K3, cuDNN, cuDNN, K3."""
    from shgan_torch.data.datasets import get_dataset
    from shgan_torch.data.formatters import get_formatter
    from shgan_torch.data.pipeline import EvalPipeline
    from shgan_torch.data.transforms import wrap_formatter
    from shgan_torch.kernels import build
    from shgan_torch.models.infer import composite_forward, z_for_positions
    from shgan_torch.runtime.stages import build_generator
    G = build_generator(cfg["model_g"], g_pth).to("cuda").eval()
    G.requires_grad_(False)
    ds_cfg = cfg["eval"]["dataset"]
    pipe = EvalPipeline(get_dataset(ds_cfg),
                        wrap_formatter(get_formatter(ds_cfg["formatter"]),
                                       ds_cfg.get("transforms")),
                        EVAL_BATCH, device="cuda", num_threads=0)
    real, mask, _, _ = next(iter(pipe))
    z = torch.from_numpy(z_for_positions(0, G.z_dim,
                                         range(EVAL_BATCH))).cuda()

    def fwd():
        with torch.inference_mode():
            return composite_forward(G, real, mask, z, noise_mode="const")

    def route(impl):
        return library_conv() if impl == "cudnn" else nullcontext()

    out, ms = {}, {"k3": [], "cudnn": []}
    for impl in ("k3", "cudnn"):
        with route(impl):
            build.reset_launches()
            out[impl] = fwd().cpu().numpy().astype(np.int16)
            out[impl + "_launches"] = build.launches["conv3x3_lowch"]
    for impl in ("k3", "cudnn", "cudnn", "k3"):
        with route(impl):
            ms[impl].append(eager_ms(fwd, 3))
    if out["k3_launches"] != 2 or out["cudnn_launches"] != 0:
        raise AssertionError(f"K3 launches on K3 / cuDNN: "
                             f"{out['k3_launches']} / "
                             f"{out['cudnn_launches']}, expected 2 / 0")
    d = np.abs(out["k3"] - out["cudnn"])
    row = {"phase": "k3_in_place", "model": MODEL_1024, "batch": EVAL_BATCH,
           "noise_mode": "const", "tf32": False,
           "within_1": float((d <= 1).mean()), "max_abs_diff": int(d.max()),
           "k3_launches_per_forward": out["k3_launches"],
           "forward_ms_k3": ms["k3"], "forward_ms_cudnn": ms["cudnn"]}
    emit(row)
    if row["within_1"] < 0.999 or row["max_abs_diff"] > 2:
        raise AssertionError(f"K3 vs cuDNN in place: {row['within_1']:.6f} "
                             f"within 1, max {row['max_abs_diff']}")
    del G
    torch.cuda.empty_cache()
    return row



# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------


def train_fir_calls(cfg_g, cfg_d, batch):
    """Every upfirdn2d call of one generator forward and one discriminator
    forward at ``batch``: (site, resolution, input shape, up, down, pads,
    gain).  The discriminator blurs before each strided 3×3 conv (pad 2)
    and its 1×1 skips downsample (down 2, pad 1)."""
    calls = fir_calls(cfg_g, batch)
    d = cfg_d["args"]
    ch = lambda r: min(int(d["ch_base"]) // r, int(d["ch_max"]))  # noqa
    r = int(d["resolution"])
    while r > 4:
        calls.append(("d_down_blur", r, (batch, ch(r), r, r), 1, 1,
                      (2, 2, 2, 2), 1))
        calls.append(("d_skip_down", r, (batch, ch(r), r, r), 1, 2,
                      (1, 1, 1, 1), 1))
        r //= 2
    return calls


# the blocks that a module built with remat checkpoints (models/remat.py)
REMAT_BLOCKS = ("EncoderBlock", "CoModSynthesisBlock", "DiscrimBlock")


def _block_sites(module):
    """(K2 calls, synthesis layers, skip-image upsamples, conv epilogues)
    of one forward of ``module``, each with the type it runs in, whether
    its block is checkpointed and the block's type: [(dtype, k2, layers,
    img, remat, convs, block)] over its top-level blocks (a block's
    ``dtype``; float32 for modules without one).  Each resampling conv is
    one K2 call, each synthesis block's skip-image upsample (float32
    always: the image pyramid is float32) one more; each Conv2dLayer with a
    bias or an lrelu_agc one conv epilogue (bias_lrelu)."""
    out = []
    for blk in module.children():
        dt = getattr(blk, "dtype", torch.float32)
        kind = type(blk).__name__
        remat = getattr(module, "remat", False) and kind in REMAT_BLOCKS
        k2 = layers = img = convs = 0
        for m in blk.modules():
            name = type(m).__name__
            if name == "Conv2dLayer":
                k2 += m.up > 1 or m.down > 1
                convs += m.bias is not None or m.activation is not None
            elif name == "SynthesisLayer":
                layers += 1
                k2 += m.up > 1
            elif name == "CoModSynthesisBlock" or (
                    name == "StyleGANSynthesisBlock" and not m.has_const):
                img += 1
        out += [(dt, k2, layers, 0, remat, convs, kind),
                (torch.float32, img, 0, img, remat, 0, kind)]
    return out


def sites_of(module, dtype=None, remat=False):
    """(K2 calls, synthesis layers, skip-image upsamples among the K2
    calls) of one forward of ``module``; with ``dtype``, only those that
    run in it; with ``remat``, only those in the blocks it checkpoints."""
    rows = [r for r in _block_sites(module)
            if dtype in (None, r[0]) and (r[4] or not remat)]
    return tuple(sum(r[i] for r in rows) for i in (1, 2, 3))


def conv_sites(module, dtype=None, remat=False, blocks=None):
    """Conv epilogues (bias_lrelu launches) of one forward of ``module``,
    filtered as :func:`sites_of` filters; with ``blocks``, only those in
    blocks of these types."""
    return sum(r[5] for r in _block_sites(module)
               if dtype in (None, r[0]) and (r[4] or not remat)
               and (blocks is None or r[6] in blocks))


def train_sites(G, D, dtype=None, remat=False):
    """(K2 calls of the encoder, of the synthesis and of D per forward,
    synthesis layers, the skip-image upsamples among the synthesis' K2
    calls, conv epilogues of the encoder, of D, and of D's blocks (those
    ahead of its minibatch stddev)), read off the modules (:func:`sites_of`,
    :func:`conv_sites`); with ``dtype``, only the calls and layers that run
    in it; with ``remat``, only those in checkpointed blocks (all zero
    where remat is off)."""
    n_syn, layers, n_img = sites_of(G.synthesis, dtype, remat)
    return (sites_of(G.encoder, dtype, remat)[0], n_syn,
            sites_of(D, dtype, remat)[0], layers, n_img,
            conv_sites(G.encoder, dtype, remat), conv_sites(D, dtype, remat),
            conv_sites(D, dtype, remat, blocks=("DiscrimBlock",)))


def expected_train_launches(n_enc, n_syn, n_d, layers, n_img, c_enc, c_d,
                            c_dr, greg, dreg, recompute=None):
    """Kernel launches of one train step.  Gmain: G and D forwards, every
    K2 call and every epilogue differentiated once.  Gpl: a G forward at
    the shrunk batch; d img / d ws runs the synthesis' K2 calls backwards
    (n_syn) and the epilogues' grad kernel; the penalty's backward runs,
    at each up-conv (n_syn - n_img of them), that backward call's own
    backward and the forward call's backward once more (the penalty reads
    the forward's activations), the encoder's backward (n_enc) but not the
    skip-image upsamples' (n_img: their backward's cotangent moves with no
    parameter), and per epilogue the grad kernel once more plus its two
    mask-only launches.  Dmain: G under no_grad (the in-place epilogue), D
    on fakes and reals, each D call differentiated.  R1: D on reals, d D /
    d real (n_d), and that gradient's backward (2 n_d).

    The conv epilogues (bias_lrelu; their gradient the same grad kernel):
    c_enc in G's encoder, c_d in D, c_dr of them in D's blocks.  One launch
    each per forward: Gmain c_enc + c_d, Dmain c_enc (no_grad, in place) +
    2 c_d, Gpl c_enc, R1 c_d.  The grad kernel at each differentiated one:
    Gmain c_enc + c_d, Dmain 2 c_d; Gpl's penalty's backward reaches the
    encoder (c_enc; d img / d ws does not); R1's d D / d real c_d, its
    backward one mask-only launch at each (c_d: with no dcoefs the second
    derivative is that alone) and the first order again at each conv
    ahead of the minibatch stddev, whose backward reads its input (c_dr).

    ``recompute``: :func:`train_sites` with ``remat`` (the K2 calls
    r_enc, r_syn, r_d and the synthesis layers r_layers inside checkpointed
    blocks).  A checkpointed block runs its forward again, K2 calls and
    epilogues, when a backward first reads its activations, once per
    backward pass that reaches it: Gmain's backward recomputes G's and D's
    blocks (r_enc + r_syn + r_d, r_layers); Dmain's, D's on fakes and
    reals (2 r_d; G ran without a gradient); Gpl's d img / d ws the
    synthesis' (r_syn, r_layers), and the penalty's backward, which
    reaches the forward's nodes again, the synthesis' once more and the
    encoder's (r_enc + r_syn, r_layers); R1's d D / d real and the
    penalty's backward D's each (2 r_d).  The conv epilogues the same way
    (rc_enc, rc_d).  The derivative kernels' counts do not move."""
    n_g = n_enc + n_syn
    want = {"upfirdn2d": (n_g + n_d) + (n_g + 2 * n_d),
            "upfirdn2d_grad": (n_g + n_d) + 2 * n_d,
            "philox_normal": 0, "conv3x3_lowch": 0,
            "noise_bias_act": 2 * layers,
            "noise_bias_act_grad": layers + (c_enc + c_d) + 2 * c_d,
            "bias_lrelu": (c_enc + c_d) + (c_enc + 2 * c_d)}
    r_enc, r_syn, r_d, r_layers, _, rc_enc, rc_d, _ = recompute or (0,) * 8
    want["upfirdn2d"] += r_enc + r_syn + 3 * r_d
    want["noise_bias_act"] += r_layers
    want["bias_lrelu"] += rc_enc + 3 * rc_d
    if greg:
        want["upfirdn2d"] += n_g
        want["upfirdn2d_grad"] += 3 * (n_syn - n_img) + n_img + n_enc
        want["noise_bias_act"] += layers
        want["noise_bias_act_grad"] += 4 * layers + c_enc
        want["bias_lrelu"] += c_enc
        want["upfirdn2d"] += r_enc + 2 * r_syn
        want["noise_bias_act"] += 2 * r_layers
        want["bias_lrelu"] += rc_enc
    if dreg:
        want["upfirdn2d"] += n_d
        want["upfirdn2d_grad"] += 3 * n_d
        want["noise_bias_act_grad"] += 2 * c_d + c_dr
        want["bias_lrelu"] += c_d
        want["upfirdn2d"] += 2 * r_d
        want["bias_lrelu"] += 2 * rc_d
    return want


def check_fir_grad(fir, calls, dtype=torch.float32):
    """K2's backward (and the backward of that, a K2 forward) at each of
    ``calls`` against autograd of fir_plain on the same inputs (float32:
    within FIR_F32_ATOL; bfloat16: one bf16 ulp + 1e-6, the plain version
    sums in float32 and rounds once as K2 does); the backward call timed
    alone beside autograd of the plain version and the cuDNN call that
    computes the same gradient."""
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]), gain=1)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(77)
    bf = dtype == torch.bfloat16
    size = 2 if bf else 4
    for site, r, shape, up, down, pads, gain in calls:
        t = taps * gain
        ups, downs = (up, up), (down, down)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        y_shape = fir.fir_plain(x[:1, :1], t, ups, downs, pads).shape[2:]
        dy = torch.randn((shape[0], shape[1]) + tuple(y_shape),
                         generator=gen, device="cuda").to(dtype)
        u = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        outs = {}
        for name, fn in (("kernel", fir.fir), ("plain", fir.fir_plain)):
            xr = x.clone().requires_grad_(True)
            dyr = dy.clone().requires_grad_(True)
            y = fn(xr, t, ups, downs, pads)
            dx, = torch.autograd.grad(y, xr, dyr, create_graph=True)
            ddy, = torch.autograd.grad((dx * u).sum(), dyr)
            outs[name] = (dx.detach(), ddy, y, xr)
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(outs["kernel"][:2], outs["plain"][:2]):
            d = (a.float() - b.float()).abs()
            err = max(err, float(d.max()))
            tol = bf16_ulp(b.float()) + 1e-6 if bf else FIR_F32_ATOL
            if not bool((d <= tol).all()):
                raise AssertionError(f"K2 backward {dtype} {site} R={r} "
                                     f"{shape}: {float(d.max())}")
        flipped = np.ascontiguousarray(t[::-1, ::-1])
        gp = fir.grad_pads(shape[2], shape[3], t, ups, downs, pads)
        bwd = lambda: fir.fir_cuda(dy, flipped, downs, ups, gp,  # noqa
                                   "upfirdn2d_grad")
        dx = outs["kernel"][0]
        nbytes = (dy.numel() + dx.numel()) * size
        it = iters_for(nbytes)
        yp, xp = outs["plain"][2], outs["plain"][3]
        row = {"site": site, "res": r, "shape": list(shape), "up": up,
               "down": down, "pads": list(pads), "backward_up": down,
               "backward_down": up, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err, "iters": it,
               "ms": graph_ms(bwd, nbytes), "eager_ms": eager_ms(bwd, it),
               "plain_ms": eager_ms(lambda: torch.autograd.grad(
                   yp, xp, dy, retain_graph=True), it)}
        c = shape[1]
        w = torch.as_tensor(np.array(t), device="cuda")[None, None].expand(
            c, 1, *t.shape).contiguous().to(dtype)
        lib = None
        if up == 1 and down == 2 and pads == (1, 1, 1, 1):
            # forward: a stride-2 conv2d; its gradient the stride-2
            # transposed conv
            lib = lambda: F.conv_transpose2d(dy, w, stride=2,  # noqa: E731
                                             padding=1, groups=c)
        elif up == 1 and len(set(pads)) == 1:   # forward: a stride-1 conv2d
            lib = lambda: torch.nn.grad.conv2d_input(  # noqa: E731
                shape, w, dy, padding=pads[0], groups=c)
        elif up == 2 and down == 1 and pads == (2, 1, 2, 1):
            # forward: the stride-2 transposed conv; its gradient a conv2d
            wt = w.flip([2, 3]).contiguous()
            lib = lambda: F.conv2d(dy, wt, stride=2, padding=1,  # noqa
                                   groups=c)
        row["library_ms"] = None
        if lib is not None:
            lib_d = (lib().float() - dx.float()).abs()
            lib_tol = 4 * bf16_ulp(dx.float()) + 1e-6 if bf else FIR_F32_ATOL
            if not bool((lib_d <= lib_tol).all()):
                raise AssertionError(f"K2 backward yardstick {site}: "
                                     f"{float(lib_d.max())}")
            row["library_ms"] = graph_ms(lib, nbytes)
        # the backward call: each dx element gathers taps / up² samples
        bound(row, nbytes, 2 * dx.numel() * (t.size // (down * down)))
        row["hbm_share"] = row["bytes_ms"] / row["ms"]
        rows.append(row)
        del outs, x, dy, u, dx
        torch.cuda.empty_cache()
    return rows


class k1_noise_in_plain:
    """Within this block the plain versions draw their noise with K1
    (``philox_normal_cuda``), bit for bit the fused kernels' noise: a
    gradient's mask flips where ``pre`` is within the normals' last-ulp
    differences of 0, so the grad kernel is held to its plain version on
    the same noise."""

    def __init__(self, nba, noise):
        self.nba, self.noise = nba, noise

    def __enter__(self):
        self.orig = self.nba.philox_normal_plain
        self.nba.philox_normal_plain = (
            lambda key, n, r, device="cpu", row0=0, h0=0, rows=None:
            self.noise.philox_normal_cuda(key, n, r, device, row0, h0, rows))

    def __exit__(self, *exc):
        self.nba.philox_normal_plain = self.orig


def check_epilogue_grad(noise, nba, cfg, batch, pl_batch, dtype=torch.float32,
                        layers=None):
    """The grad kernel at each synthesis layer shape of ``cfg`` (or
    ``layers``): its full mode at ``batch`` (the main phases' backward)
    against its plain version on the same noise, dx within 4 float32 ulp
    (bfloat16 I/O: one bf16 ulp) and the sums within 1e-5 of the sum of
    their terms' magnitudes; its mask-only mode at ``pl_batch`` (the
    path-length penalty's double backward) within the same ulps; its
    regenerated noise against K1's bit for bit (in bf16: K1's rounded);
    timed beside the plain version and autograd of the PyTorch chain on
    the same inputs."""
    from shgan_torch.ops.bias_act import parse_activation
    spec = cfg["args"]["synthesis"]["args"].get(
        "activation", "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")
    act = nba.epilogue_act(parse_activation(spec))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(batch + 5)
    bf = dtype == torch.bfloat16
    size = 2 if bf else 4
    ulps = (lambda v: bf16_ulp(v.float())) if bf else (  # noqa: E731
        lambda v: 4 * 2.0 ** (torch.floor(torch.log2(
            v.abs().clamp_min(1e-30))) - 23))
    for (r, c), count in sorted((layers or epilogue_layers(cfg)).items()):
        key = noise.noise_key(4321, 2 * r)
        x = torch.randn((batch, c, r, r), generator=gen,
                        device="cuda").to(dtype)
        dy = torch.randn((batch, c, r, r), generator=gen,
                         device="cuda").to(dtype)
        d = torch.rand((batch, c), generator=gen, device="cuda") + 0.5
        b = torch.randn((c,), generator=gen, device="cuda") * 0.1
        s = torch.full((), 0.1, device="cuda")
        kw = dict(dcoefs=d, bias=b, act=act, noise_mode="random",
                  noise_key=key, strength=s)
        got = nba.noise_bias_act_grad_cuda(dy, x, **kw)
        with k1_noise_in_plain(nba, noise):
            want = nba.noise_bias_act_grad_plain(dy, x, **kw)
            g = nba.noise_bias_act_mask_plain(dy, x, **kw).double()
        nu = noise.philox_normal_cuda(key, batch, r, "cuda")[:, None]
        torch.cuda.synchronize()
        if got[0].dtype != dtype or any(t.dtype != torch.float32
                                        for t in got[1:]):
            raise AssertionError(f"grad kernel types {[t.dtype for t in got]}")
        dxd = (got[0].float() - want[0].float()).abs()
        err = float(dxd.max())
        if not bool((dxd <= ulps(want[0])).all()):
            raise AssertionError(f"grad kernel {dtype} dx R={r} C={c}: {err}")
        sums_rel = 0.0
        x64 = x.double()
        for a, w_, mag in ((got[1], want[1], (g * x64).abs().sum((2, 3))),
                           (got[2], want[2], g.abs().sum((0, 2, 3))),
                           (got[3], want[3], (g * nu).abs().sum())):
            rel = float(((a.double() - w_.double()).abs()
                         / (mag + 1e-30)).max())
            sums_rel = max(sums_rel, rel)
        if not sums_rel <= 1e-5:
            raise AssertionError(f"grad kernel sums R={r} C={c}: {sums_rel}")
        # the regenerated noise: mask-only, v = 0, vs = 1, linear, gain 1
        zero = torch.zeros((batch, c, r, r), device="cuda", dtype=dtype)
        nu_k = nba.noise_bias_act_mask_cuda(
            zero, zero, noise_mode="random", noise_key=key,
            strength=torch.ones((), device="cuda"),
            vs=torch.ones((), device="cuda"))
        if not torch.equal(nu_k, nu.to(dtype).expand_as(nu_k)):
            raise AssertionError(f"grad kernel's noise != K1 at R={r}")
        # mask-only at the path-length batch
        v = dy[:pl_batch].contiguous()
        kwp = dict(kw, dcoefs=d[:pl_batch].contiguous())
        m_got = nba.noise_bias_act_mask_cuda(v, x[:pl_batch].contiguous(),
                                             **kwp)
        with k1_noise_in_plain(nba, noise):
            m_want = nba.noise_bias_act_mask_plain(
                v, x[:pl_batch].contiguous(), **kwp)
        md = (m_got.float() - m_want.float()).abs()
        if not bool((md <= ulps(m_want)).all()):
            raise AssertionError(f"mask-only {dtype} R={r}: "
                                 f"{float(md.max())}")
        nbytes = 3 * x.numel() * size + (d.numel() + b.numel() + 1) * 4
        it = iters_for(nbytes)
        kern = lambda: nba.noise_bias_act_grad_cuda(dy, x, **kw)  # noqa
        xr, dr, br, sr = (t.clone().requires_grad_(True) for t in (x, d, b, s))
        yr = nba.noise_bias_act_plain(xr, dr, br, act, noise_mode="random",
                                      noise_key=key, strength=sr)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            yr, (xr, dr, br, sr), dy, retain_graph=True)
        row = {"res": r, "channels": c, "batch": batch,
               "dtype": str(dtype).split(".")[-1],
               "layers_per_forward": count, "max_abs_err": err,
               "sums_max_rel_err": sums_rel, "noise_equals_k1": True,
               "iters": it, "ms": graph_ms(kern, nbytes),
               "eager_ms": eager_ms(kern, it),
               "plain_ms": eager_ms(lambda: nba.noise_bias_act_grad_plain(
                   dy, x, **kw), 3),
               "library_ms": eager_ms(lib, it),
               "mask_ms": graph_ms(lambda: nba.noise_bias_act_mask_cuda(
                   v, x[:pl_batch].contiguous(), **kwp), nbytes // 2)}
        # dy and x read once, dx written once; the normals regenerated
        # (~65 operations a pixel) and ~12 operations an element
        bound(row, nbytes, batch * r * r * 65 + x.numel() * 12)
        row["hbm_share"] = row["bytes_ms"] / row["ms"]
        rows.append(row)
        del x, dy, got, want, g, nu, zero, nu_k, v, m_got, m_want, yr
        torch.cuda.empty_cache()
    return rows


# the bf16 training configuration of the JAX package's bench.py:307-310:
# G's encoder and D below, and G's synthesis above, 16² in bfloat16
BF16_TRAIN = {"model_g.args.encoder.args.use_fp16_before_res": 16,
              "model_g.args.synthesis.args.use_fp16_after_res": 16,
              "model_d.args.use_fp16_before_res": 16}


def train_config(tmp, steps, bf16=False):
    """``shgan_ffhq256_train`` through the CLI's config assembly: the model
    as configured (``shgan_g256`` + ``comodgan_d256``, float32, or with
    ``bf16`` the blocks of ``BF16_TRAIN`` in bfloat16, batch 8), the
    dataset swapped to synthetic 256² (FFHQ is not on the machine),
    ``steps`` steps in two ticks, one snapshot at the end."""
    from shgan_torch.main import build_config
    nimg = steps * TRAIN_BATCH
    return build_config(
        TRAIN_EXPERIMENT, dataset="synthetic256_inpainting",
        log_root=os.path.join(tmp, "train_bf16" if bf16 else "train"),
        overrides={"train.experiment_id": 0,
                   "train.total_kimg": nimg / 1000,
                   "train.kimg_per_tick": nimg / 2000,
                   "train.snapshot_ticks": 1000,
                   **(BF16_TRAIN if bf16 else {})})


BF16_KEYS = ("upfirdn2d", "upfirdn2d_grad", "noise_bias_act",
             "noise_bias_act_grad", "bias_lrelu")
bf16_launches = dict.fromkeys(BF16_KEYS, 0)


class bf16_tally:
    """Within this block the launches of K2 (forward and derivative), the
    fused epilogue (or bias_lrelu, by the kernel it runs) and its grad
    kernel (both modes) on bfloat16 tensors are counted in
    ``bf16_launches`` as well, by wrapping the wrappers."""

    def __init__(self, fir, nba):
        self.fir, self.nba = fir, nba

    def __enter__(self):
        fir, nba = self.fir, self.nba
        self.orig = (fir.fir_cuda, nba.noise_bias_act_cuda, nba._grad_launch)
        f_fir, f_nba, f_grad = self.orig

        def fir_cuda(x, *a, **k):
            counter = k.get("counter", a[4] if len(a) > 4 else "upfirdn2d")
            if x.dtype == torch.bfloat16:
                bf16_launches[counter] += 1
            return f_fir(x, *a, **k)

        def noise_bias_act_cuda(x, *a, **k):
            if x.dtype == torch.bfloat16:
                bf16_launches[nba.kernel_of(
                    k.get("dcoefs", a[0] if a else None),
                    k.get("noise_mode", a[3] if len(a) > 3 else "none"))] += 1
            return f_nba(x, *a, **k)

        def grad_launch(v, x, *a, **k):
            if x.dtype == torch.bfloat16:
                bf16_launches["noise_bias_act_grad"] += 1
            return f_grad(v, x, *a, **k)
        fir.fir_cuda, nba.noise_bias_act_cuda, nba._grad_launch = (
            fir_cuda, noise_bias_act_cuda, grad_launch)
        return self

    def __exit__(self, *exc):
        (self.fir.fir_cuda, self.nba.noise_bias_act_cuda,
         self.nba._grad_launch) = self.orig


def reset_bf16_launches():
    for k in bf16_launches:
        bf16_launches[k] = 0


def params_of(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def max_diff(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def parity_grads(cfg, dev, seed=0, strength=0.1, patch=None):
    """The G gradient of one Gmain and the D gradient of one Dmain + R1 at
    batch 2 on ``dev``, from weights drawn from ``seed`` with every bias
    moved by N(0, 0.1) (zero-initialised biases would put the SHU's ReLU
    kinks on the spectra's exact zeros, the imaginary DC and Nyquist bins,
    whose sign is each FFT library's rounding) and every noise_strength at
    ``strength``; the draws from CPU generators; ``patch(G, D)``, where
    given, returns the models to run in their place once they are on
    ``dev``.  Returns ({leaf: grad on the CPU}, seconds)."""
    from shgan_torch.models.registry import get_model
    from shgan_torch.train import loss as L
    g = torch.Generator().manual_seed(seed)
    res = int(cfg["model_g"]["args"]["synthesis"]["args"]["resolution"])
    z_dim = int(cfg["model_g"]["args"]["mapping"]["args"]["z_dim"])
    real = (torch.rand(PARITY_BATCH, 3, res, res, generator=g) * 2 - 1).to(dev)
    mask = (torch.rand(PARITY_BATCH, 1, res, res, generator=g) > 0.5).float()
    mask = mask.to(dev)
    z = torch.randn(PARITY_BATCH, z_dim, generator=g).to(dev)
    G = get_model(cfg["model_g"], seed=seed)
    D = get_model(cfg["model_d"], seed=seed + 1)
    gb = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for name, p in list(G.named_parameters()) + list(D.named_parameters()):
            if name.endswith("noise_strength"):
                p.fill_(strength)
            elif name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=gb) * 0.1)
    G, D = G.to(dev), D.to(dev)
    if patch is not None:
        G, D = patch(G, D)
    x_in = torch.cat([mask - 0.5, real * mask], dim=1)
    t0 = time.perf_counter()
    D.requires_grad_(False)
    loss, _ = L.g_main_loss(G, D, x_in, mask, z,
                            torch.Generator().manual_seed(1), 0.9)
    loss.backward()
    D.requires_grad_(True)
    G.requires_grad_(False)
    loss_d, _ = L.d_main_loss(G, D, x_in, mask, real, z,
                              torch.Generator().manual_seed(2), 0.9)
    loss_r1, _ = L.d_r1_loss(D, mask, real)
    (loss_d + loss_r1).backward()
    grads = {**{"G." + k: p.grad.detach().cpu()
                for k, p in G.named_parameters() if p.grad is not None},
             **{"D." + k: p.grad.detach().cpu()
                for k, p in D.named_parameters()}}
    return grads, time.perf_counter() - t0


class cudnn_flags:
    """cuDNN's ``benchmark`` and ``deterministic`` flags set within the
    block (both off unless given), restored after."""

    def __init__(self, benchmark=False, deterministic=False):
        self.flags = (benchmark, deterministic)

    def __enter__(self):
        c = torch.backends.cudnn
        self.prev = (c.benchmark, c.deterministic)
        c.benchmark, c.deterministic = self.flags

    def __exit__(self, *exc):
        c = torch.backends.cudnn
        c.benchmark, c.deterministic = self.prev


def rel_errs(a, b):
    """[(|a - b| / |b|, leaf)] over the leaves, the worst first."""
    if set(a) != set(b):
        raise AssertionError(f"gradient leaves differ: {set(a) ^ set(b)}")
    return sorted(((float((a[k] - v).norm()) / max(float(v.norm()), 1e-12),
                    k) for k, v in b.items()), reverse=True)


# Gradient leaves whose card and CPU values differ by design beyond float32
# rounding: a noise_strength's gradient is the sum over its layer of g·ν,
# which cancels, and the two devices draw ν by different code (K1's libm
# normals, the plain version's torch normals, last-ulp apart); the SHU's
# spectral conv sums over the spectrum of cuFFT's or the CPU FFT's output.
PARITY_LOOSE = ("noise_strength", "encoder.shu.")
PARITY_TOL, PARITY_LOOSE_TOL = 1e-3, 1e-2
# a noise strength's gradient Σ ν·g against the magnitude of its terms,
# Σ |ν·g| (the CPU run's): the tight rule, on every card run
NOISE_TERMS_TOL = 1e-3


def is_loose(leaf):
    return any(t in leaf for t in PARITY_LOOSE)


class noise_terms:
    """Within the block, each ``noise_strength`` leaf's Σ |ν·g| over the
    plain grad kernel's calls (the CPU's epilogue gradient: g the
    cotangent of the activation's input, ν the noise before the strength),
    summed in float64 into ``terms[leaf]``; :meth:`patch` is
    :func:`parity_grads`'s hook that names the leaves."""

    def __init__(self):
        self.terms, self.names = {}, {}

    def patch(self, G, D):
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                self.names[p.data_ptr()] = "G." + name
        return G, D

    def __enter__(self):
        from shgan_torch.ops import noise_bias_act as nba
        self.orig = plain = nba.noise_bias_act_grad_plain

        def grad_plain(dy, x, dcoefs=None, bias=None, act=nba.LINEAR,
                       noise_mode="none", noise_key=None, noise_const=None,
                       strength=None, row0=0, h0=None):
            out = plain(dy, x, dcoefs, bias, act, noise_mode, noise_key,
                        noise_const, strength, row0, h0)
            if noise_mode != "none":
                g = nba.noise_bias_act_mask_plain(
                    dy, x, dcoefs, bias, act, noise_mode, noise_key,
                    noise_const, strength, row0=row0, h0=h0)
                nu = nba._noise_plain(x, noise_mode, noise_key, noise_const,
                                      row0, h0)
                leaf = self.names[strength.data_ptr()]
                self.terms[leaf] = self.terms.get(leaf, 0.0) + float(
                    (g.double() * nu.double()).abs().sum())
            return out
        nba.noise_bias_act_grad_plain = grad_plain
        return self

    def __exit__(self, *exc):
        from shgan_torch.ops import noise_bias_act as nba
        nba.noise_bias_act_grad_plain = self.orig


def noise_term_errs(card, cpu, terms):
    """[(|card - cpu| / Σ |ν·g|, leaf)] over the noise strengths, the
    worst first."""
    return sorted((float((card[k] - cpu[k]).abs().max()) / max(t, 1e-30), k)
                  for k, t in terms.items())[::-1]


def train_parity(cfg, seed=0):
    """One Gmain, Dmain and R1 gradient at batch 2 on the card and on the
    CPU (the plain versions), the same weights and draws, TF32 off, every
    noise_strength at its initial 0: each gradient leaf's difference within
    1e-3 of its norm, the PARITY_LOOSE leaves within 1e-2.  The gated card
    run uses cuDNN's deterministic algorithms, so the verdict is the same
    on every run; two more card runs, under cuDNN's default algorithms
    (some of them nondeterministic) and under its autotuner, give each
    leaf's float32 spread on one device and the default run's distance
    from the CPU, for the record.  Each noise strength's gradient, a sum
    Σ ν·g that cancels, is also held against the magnitude of its terms,
    Σ |ν·g| (from the CPU run): within 1e-3 of it on all three card
    runs."""
    with cudnn_flags(deterministic=True):
        card, card_s = parity_grads(cfg, "cuda", seed, strength=0.0)
    nt = noise_terms()
    with nt:
        cpu, cpu_s = parity_grads(cfg, "cpu", seed, strength=0.0,
                                  patch=nt.patch)
    card_default, _ = parity_grads(cfg, "cuda", seed, strength=0.0)
    with cudnn_flags(benchmark=True):
        card2, _ = parity_grads(cfg, "cuda", seed, strength=0.0)
    noise_leaves = sorted(k for k in cpu if k.endswith("noise_strength"))
    if sorted(nt.terms) != noise_leaves:
        raise AssertionError(f"noise terms of {sorted(nt.terms)}, leaves "
                             f"{noise_leaves}")
    # each noise strength's error against the magnitude of its terms, on
    # the three card runs (deterministic, default, autotuned algorithms)
    terms_rel = {run: noise_term_errs(g, cpu, nt.terms)
                 for run, g in (("deterministic", card),
                                ("default", card_default),
                                ("autotuned", card2))}
    rel = rel_errs(card, cpu)
    spread = dict((k, e) for e, k in rel_errs(card2, card))
    loose = [(e, k) for e, k in rel if is_loose(k)]
    tight = [(e, k) for e, k in rel if not is_loose(k)]
    rel_d = rel_errs(card_default, cpu)
    row = {"phase": "train_parity", "batch": PARITY_BATCH, "tf32": False,
           "cudnn_deterministic": True, "noise_strength": 0.0,
           "leaves": len(cpu),
           "worst_rel_err": tight[0][0], "worst_leaf": tight[0][1],
           "worst_5": [(e, k, spread[k]) for e, k in tight[:5]],
           "loose_leaves": len(loose),
           "loose_worst_5": [(e, k, spread[k]) for e, k in loose[:5]],
           "median_rel_err": rel[len(rel) // 2][0],
           "median_card_spread": sorted(spread.values())[len(spread) // 2],
           "default_algos_worst": next(r for r in rel_d
                                       if not is_loose(r[1])),
           "default_algos_loose_worst": next(r for r in rel_d
                                             if is_loose(r[1])),
           "noise_terms": nt.terms,
           "noise_vs_terms": terms_rel,
           "noise_vs_terms_worst": {run: r[0] for run, r in
                                    terms_rel.items()},
           "noise_vs_terms_tol": NOISE_TERMS_TOL,
           "cuda_s": card_s, "cpu_s": cpu_s}
    emit(row)
    if not (tight[0][0] <= PARITY_TOL and loose[0][0] <= PARITY_LOOSE_TOL):
        raise AssertionError(f"train card vs CPU: {tight[0]}, {loose[0]}")
    bad = {run: r[0] for run, r in terms_rel.items()
           if r[0][0] > NOISE_TERMS_TOL}
    if bad:
        raise AssertionError(f"noise strengths card vs CPU over the "
                             f"magnitude of their terms: {bad}")
    return row


def train_path(tmp, cli, build, bf16=False):
    """The training path as the CLI runs it (``main.run`` of the assembled
    config), with launch counts per step; then the
    snapshot reloaded and one step from it against the same step from
    memory (cuDNN deterministic).  With ``bf16`` the model runs the blocks
    of ``BF16_TRAIN`` in bfloat16, and the launches on bfloat16 tensors
    (counted inside a :class:`bf16_tally`) are held per step to the same
    rule over the sites that run in bfloat16."""
    from shgan_torch.checkpoint.train_state import load_train_state
    from shgan_torch.data.datasets import get_dataset
    from shgan_torch.data.formatters import get_formatter
    from shgan_torch.data.pipeline import TrainPipeline
    from shgan_torch.data.transforms import wrap_formatter
    from shgan_torch.models.registry import get_model
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    cfg = train_config(tmp, TRAIN_STEPS, bf16)
    # launches in each step, and outside the steps (before step 0, between
    # steps, after the last): the counts are set to 0 as each step starts
    # and read as it ends
    per_step, outside, per_step_bf16, per_step_mod = [], [], [], []

    def on_step_start(i):
        outside.append(dict(build.launches))
        build.reset_launches()
        reset_bf16_launches()

    def on_step(i, metrics):
        per_step.append(dict(build.launches))
        per_step_bf16.append(dict(bf16_launches))
        per_step_mod.append(build.snapshot_modconv())
        build.reset_launches()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    rv = cli.run(cfg, on_step=on_step, on_step_start=on_step_start)
    outside.append(dict(build.launches))
    stage_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step = rv["step"]
    tc = step.cfg
    sites = train_sites(step.G, step.D)
    sites16 = train_sites(step.G, step.D, torch.bfloat16)
    for i, got in enumerate(per_step):
        regs = (i % tc.g_reg_interval == 0, i % tc.d_reg_interval == 0)
        want = expected_train_launches(*sites, *regs)
        if got != want:
            raise AssertionError(f"train step {i} launches {got}, "
                                 f"expected {want}")
        if bf16:
            want16 = {k: v for k, v in expected_train_launches(
                *sites16, *regs).items() if k in BF16_KEYS}
            if per_step_bf16[i] != want16 or not all(want16.values()):
                raise AssertionError(f"train step {i} bf16 launches "
                                     f"{per_step_bf16[i]}, expected "
                                     f"{want16}")
    for i, got in enumerate(per_step_mod):
        want = train_modconv(step.G.synthesis, i % tc.g_reg_interval == 0,
                             tc.grad_accum)
        if got != want:
            raise AssertionError(f"train step {i} modulated convs {got}, "
                                 f"expected {want}")
    if len(per_step) != TRAIN_STEPS or step.step != TRAIN_STEPS:
        raise AssertionError(f"{len(per_step)} steps run")
    # G_ema's image grids: fakes_init.png before step 0 and the final
    # fakes000000.png after the last step (no image tick in between), each
    # GRID_FORWARDS forwards of G without a gradient, nothing else
    demo = os.path.join(cfg["train"]["log_dir"], "demo")
    grids = sorted(f for f in os.listdir(demo) if f.startswith("fakes")
                   and not f.endswith("_combined.png"))
    if grids != ["fakes000000.png", "fakes_init.png"]:
        raise AssertionError(f"training grids {grids}")
    fwd = {k: 0 for k in build.launches}
    fwd.update(upfirdn2d=GRID_FORWARDS * (sites[0] + sites[1]),
               noise_bias_act=GRID_FORWARDS * sites[3],
               bias_lrelu=GRID_FORWARDS * sites[5])
    none = {k: 0 for k in build.launches}
    want = [fwd] + [none] * (TRAIN_STEPS - 1) + [fwd]
    if outside != want:
        raise AssertionError(f"launches outside the steps {outside}, "
                             f"expected {want}")
    stats = [json.loads(line) for line in open(os.path.join(
        cfg["train"]["log_dir"], "stats.jsonl"))]
    if [r["step"] for r in stats] != [TRAIN_STEPS * TRAIN_BATCH // 2,
                                      TRAIN_STEPS * TRAIN_BATCH]:
        raise AssertionError(f"stats.jsonl steps {[r['step'] for r in stats]}")
    ticks = rv["ticks"]
    for t in ticks:
        for k in ("loss_g", "loss_d", "pl_mean", "r1_penalty"):
            if not math.isfinite(t[k]):
                raise AssertionError(f"tick {t['tick']}: {k} = {t[k]}")
    if not float(step.pl_mean) > 0:
        raise AssertionError(f"pl_mean {float(step.pl_mean)}")
    init = get_model(cfg["model_g"], seed=0).state_dict()
    moved = max(float((v.cpu() - init[k]).abs().max())
                for k, v in step.G.state_dict().items()
                if k.endswith("weight"))
    if not moved > 0:
        raise AssertionError("G's weights did not move")
    timing = rv["timing"]
    row = {"phase": "train_path_bf16" if bf16 else "train_path",
           "experiment": TRAIN_EXPERIMENT, "bf16_blocks": bf16,
           "model_g": cfg["model_g"].get("name"),
           "model_d": cfg["model_d"].get("name"),
           "dataset": cfg["train"]["dataset"]["name"], "batch": TRAIN_BATCH,
           "steps": TRAIN_STEPS, "regs": [
               ("G" if i % tc.g_reg_interval == 0 else "")
               + ("D" if i % tc.d_reg_interval == 0 else "")
               for i in range(TRAIN_STEPS)],
           "step_ms": [s * 1e3 for s in timing["step_s"]],
           "images_per_s_steps_1_5": TRAIN_BATCH * (TRAIN_STEPS - 1)
           / sum(timing["step_s"][1:]),
           "peak_mem_gib": peak_gib, "stage_s": stage_s,
           "launches_per_step": per_step,
           "modconv_per_step": per_step_mod,
           "bf16_launches_per_step": per_step_bf16 if bf16 else None,
           "bf16_sites": dict(zip(
               ("k2_encoder", "k2_synthesis", "k2_discriminator",
                "synthesis_layers", "k2_skip_image"), sites16))
           if bf16 else None,
           "launches_per_grid": fwd, "grids": grids,
           "stats_jsonl_keys": sorted(stats[0]), "sites": dict(zip(
               ("k2_encoder", "k2_synthesis", "k2_discriminator",
                "synthesis_layers", "k2_skip_image"), sites)),
           "ticks": ticks, "pl_mean": float(step.pl_mean),
           "max_weight_move": moved}
    emit(row)

    # the snapshot, reloaded; one step from it and from memory
    snap = os.path.join(cfg["train"]["log_dir"], "weight",
                        "network-snapshot-000000")
    with cudnn_flags(deterministic=True):
        fresh = TrainStep(get_model(cfg["model_g"], seed=9).cuda(),
                          get_model(cfg["model_d"], seed=9).cuda(), tc)
        load_train_state(snap, fresh)
        if fresh.step != step.step:
            raise AssertionError(f"snapshot step {fresh.step}")
        ds = cfg["train"]["dataset"]
        pipe = TrainPipeline(get_dataset(ds), wrap_formatter(
            get_formatter(ds["formatter"]), ds.get("transforms")),
            TRAIN_BATCH, device="cuda", num_threads=0, start=step.step)
        real, mask = next(iter(pipe))
        outs = []
        for st in (step, fresh):
            st(real, mask, step_generator(0, st.step), 0.999, True, True)
            outs.append((params_of(st.G), params_of(st.D),
                         params_of(st.G_ema), float(st.pl_mean)))
    diffs = [max_diff(a, b) for a, b in zip(outs[0][:3], outs[1][:3])]
    resume = {"phase": "train_resume_bf16" if bf16 else "train_resume",
              "snapshot": os.path.basename(snap),
              "step": step.step, "max_abs_diff_G_D_Gema": diffs,
              "pl_mean": [outs[0][3], outs[1][3]]}
    emit(resume)
    if any(diffs) or outs[0][3] != outs[1][3]:
        raise AssertionError(f"resumed step differs: {resume}")
    del fresh, step, rv
    torch.cuda.empty_cache()
    return row, cfg


# ---------------------------------------------------------------------------
# the published eval protocol: shgan_ffhq256_fullmetrics_eval
# ---------------------------------------------------------------------------

FULL_EXPERIMENT = "shgan_ffhq256_fullmetrics_eval"
FULL_G = "shgan_g256"
FULL_IMAGES = 256     # FFHQ-named PNGs in data/ffhq/ffhq256x256.zip
FULL_RES = 256
PREGEN_IMAGES = 64    # the in-process pregen run's images
CACHED_RTOL = 1e-4    # fid, kid, pr with the real-feature cache vs without
LPIPS_ENV = ("SHGAN_TPU_ALEXNET", "SHGAN_TPU_LPIPS_LIN", "SHGAN_TPU_VGG16",
             "SHGAN_TPU_LPIPS_LIN_VGG")


def ffhq_zip(root, n, res, seed=0):
    """``<root>/data/ffhq/ffhq256x256.zip``: ``n`` smooth random RGB
    images named as FFHQ's (``00000.png`` …) from a numpy seed; returns the
    directory holding the zip and the images as uint8 HWC."""
    from PIL import Image
    import io
    import zipfile
    d = os.path.join(root, "data", "ffhq")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    imgs = []
    with zipfile.ZipFile(os.path.join(d, "ffhq256x256.zip"), "w") as z:
        for i in range(n):
            low = torch.from_numpy(rng.rand(1, 3, 8, 8).astype(np.float32))
            img = F.interpolate(low, size=(res, res), mode="bicubic",
                                align_corners=False)[0].numpy()
            img = img + 0.05 * rng.randn(3, res, res).astype(np.float32)
            img = np.rint(np.clip(img, 0, 1) * 255).astype(np.uint8)
            imgs.append(img.transpose(1, 2, 0))
            buf = io.BytesIO()
            Image.fromarray(imgs[-1]).save(buf, format="PNG")
            z.writestr(f"{i:05d}.png", buf.getvalue())
    return d, imgs


def lpips_weight_files(tmp, seed=0):
    """Random AlexNet, VGG16 and both LPIPS-lin ``.pth`` files in
    torchvision's and lpips' key layouts; → {environment variable: path}."""
    from shgan_torch.eval import lpips
    out = {}
    for net, params, (bvar, lvar) in (
            ("alex", lpips.random_lpips_params(seed), LPIPS_ENV[:2]),
            ("vgg16", lpips.random_vgg16_lpips_params(seed), LPIPS_ENV[2:])):
        backbone, lin = lpips.torchvision_state_dicts(params, net)
        out[bvar] = os.path.join(tmp, f"{net}_backbone.pth")
        out[lvar] = os.path.join(tmp, f"{net}_lin.pth")
        torch.save(backbone, out[bvar])
        torch.save(lin, out[lvar])
    return out


def fullmetrics_config(tmp, g_pth, data_root, log_sub, evaluators=None):
    """``shgan_ffhq256_fullmetrics_eval`` through the CLI's config assembly
    as configured (``shgan_g256``, batch 16, random noise, fid + kid + pr +
    is, ppl2_wend with 2000 samples in w space at ε 1e-4 on vgg16, lpips
    alex, psnr, ssim), the dataset root pointed at ``data_root`` and the
    real-feature cache under ``tmp``."""
    from shgan_torch.main import build_config
    cfg = build_config(FULL_EXPERIMENT, eval_id=0, pretrained=g_pth,
                       log_root=os.path.join(tmp, log_sub))
    ev = cfg["eval"]
    ev["dataset"]["root_dir"] = data_root
    ev["log_display"] = FULL_IMAGES
    evs = ev["evaluator"]
    if evaluators is not None:
        evs = [e for e in evs if e["type"] in evaluators]
    for e in evs:
        if e["type"] in ("fid", "kid", "pr", "is"):
            e["args"] = dict(e.get("args") or {},
                             cache_dir=os.path.join(tmp, "cache"))
    ev["evaluator"] = evs
    return cfg


def fullmetrics_launches(g_cfg, batch, images, ppl_samples, ppl_batch):
    """The launches of a fullmetrics eval, worked out from the modules:
    ``images / batch`` stream forwards, then ``ppl_samples / ppl_batch``
    PPL batches of one encoder and two synthesis passes each; K2's by route
    (``stride1``: up = down = 1, ``up2``: the skip-image upsample), the
    fused epilogue's and bias_lrelu's (the encoder's conv epilogues)."""
    calls = fir_calls(g_cfg, batch)
    per_fwd = {"stride1": sum(c[3] == 1 for c in calls),
               "up2": sum(c[3] == 2 for c in calls)}
    per_enc = sum(c[0] == "enc_down_blur" for c in calls)
    layers = sum(noise_layers(g_cfg).values())
    convs = sum(encoder_conv_layers(g_cfg).values())
    n_batches = -(-images // batch)
    ppl_batches = -(-ppl_samples // ppl_batch)
    return {"stream_forwards": n_batches, "ppl_batches": ppl_batches,
            "upfirdn2d_per_forward": per_fwd, "upfirdn2d_encoder": per_enc,
            "noise_bias_act_per_forward": layers,
            "bias_lrelu_per_forward": convs,
            "upfirdn2d_by_route": {
                "stride1": n_batches * per_fwd["stride1"] + ppl_batches
                * (per_enc + 2 * (per_fwd["stride1"] - per_enc)),
                "up2": (n_batches + 2 * ppl_batches) * per_fwd["up2"],
                "other": 0},
            "noise_bias_act": (n_batches + 2 * ppl_batches) * layers,
            "bias_lrelu": (n_batches + ppl_batches) * convs}


class graph_tallies:
    """Tallies that this script keeps beside the wrappers' counts (dicts
    that wrappers of the kernel wrappers count into) made to count a
    captured graph's replays, by the rule ``runtime/compiled.py`` keeps for
    ``build.launches``: within the block, what a graph's warm-up and
    capture count into them is taken back, the capture's share is
    recorded with the graph and added once per replay.  A graph captured
    outside the block adds nothing to them."""

    def __init__(self, *tallies):
        self.tallies = tallies

    def __enter__(self):
        from shgan_torch.runtime.compiled import CompiledForward as C
        self.orig = (C._warm_up, C._record, C._replay)
        warm_up, record, replay = self.orig
        tallies = self.tallies

        def snap():
            return [dict(t) for t in tallies]

        def restore(saved):
            for t, v in zip(tallies, saved):
                t.update(v)

        def warm(cf, st):
            saved = snap()
            warm_up(cf, st)
            restore(saved)

        def rec(cf, st):
            saved = snap()
            out = record(cf, st)
            st.tallies = [{k: t[k] - v[k] for k in t}
                          for t, v in zip(tallies, saved)]
            restore(saved)
            return out

        def play(cf, st):
            for t, d in zip(tallies, getattr(st, "tallies", ())):
                for k, v in d.items():
                    t[k] += v
            return replay(cf, st)
        C._warm_up, C._record, C._replay = warm, rec, play
        return self

    def __exit__(self, *exc):
        from shgan_torch.runtime.compiled import CompiledForward as C
        C._warm_up, C._record, C._replay = self.orig


def fir_route_tally(fir):
    """Wrap K2's launch function so each launch is tallied by its route
    (up = down = 1: the stride-1 tiles; up = 2: the resampling tiles; any
    other: the generic kernel) beside the wrapper's own count, a captured
    graph's replays included (:class:`graph_tallies`); → (tally, undo)."""
    tally = {"stride1": 0, "up2": 0, "other": 0}
    orig = fir.fir_cuda
    graphs = graph_tallies(tally).__enter__()

    def counted(x, taps, up=(1, 1), down=(1, 1), pads=(0, 0, 0, 0),
                counter="upfirdn2d"):
        key = ("stride1" if tuple(up) == tuple(down) == (1, 1) else
               "up2" if tuple(up) == (2, 2) and tuple(down) == (1, 1)
               else "other")
        tally[key] += 1
        return orig(x, taps, up, down, pads, counter)

    def undo():
        fir.fir_cuda = orig
        graphs.__exit__()

    fir.fir_cuda = counted
    return tally, undo


def fullmetrics_path(tmp, cli, build, fir, inc_pth):
    """The published eval protocol on the card: the fullmetrics experiment
    at full-width ``shgan_g256`` on an FFHQ-format zip, with launch counts
    by route over the stream and the PPL forwards; PPL's noise at ε = 0;
    the run again with the real-feature cache; the pre-generated protocol
    in process and through the CLI."""
    from PIL import Image
    from shgan_torch.eval.lpips import (lpips_params_to,
                                        random_vgg16_lpips_params)
    from shgan_torch.eval.ppl import make_ppl_sampler
    from shgan_torch.runtime.stages import build_generator
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "fullmetrics")
    os.makedirs(work)
    data_root, reals = ffhq_zip(work, FULL_IMAGES, FULL_RES)
    g_pth = os.path.join(work, f"{FULL_G}_random.pth")
    random_weights(FULL_G, g_pth)
    env = dict(lpips_weight_files(work), SHGAN_TPU_INCEPTION=inc_pth)
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = fullmetrics_config(work, g_pth, data_root, "log")
        ev = cfg["eval"]
        batch = ev["batch_size_per_gpu"]
        ppl_cfg = next(e["args"] for e in ev["evaluator"]
                       if e["type"] == "ppl")
        g_cfg = cfg["model_g"]
        rule = fullmetrics_launches(g_cfg, batch, FULL_IMAGES,
                                    ppl_cfg["num_samples"],
                                    ppl_cfg["batch_size"])
        want_route = rule["upfirdn2d_by_route"]
        want = {k: 0 for k in build.launches}
        want.update(upfirdn2d=sum(want_route.values()),
                    noise_bias_act=rule["noise_bias_act"],
                    bias_lrelu=rule["bias_lrelu"])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tally, undo = fir_route_tally(fir)
        build.reset_launches()
        t0 = time.perf_counter()
        try:
            rv = cli.run(cfg)
        finally:
            undo()
        run_s = time.perf_counter() - t0
        launches = dict(build.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if launches != want or tally != want_route:
            raise AssertionError(f"fullmetrics launches {launches} by route "
                                 f"{tally}, expected {want} by route "
                                 f"{want_route}")
        with open(os.path.join(ev["log_dir"], "result.json")) as f:
            result = json.load(f)
        metrics = {"fid": result["fid"]["fid"], "kid": result["kid"]["kid"],
                   "precision": result["pr"]["precision"],
                   "recall": result["pr"]["recall"],
                   "is_mean": result["is"]["is_mean"],
                   "is_std": result["is"]["is_std"],
                   "ppl": result["ppl"]["ppl"],
                   "lpips": result["lpips"]["lpips"],
                   "psnr": result["psnr"]["psnr"],
                   "ssim": result["ssim"]["ssim"]}
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"fullmetrics result.json: {metrics}")
        timing = rv["timing"]
        stream_s = sum(timing["batch_s"][1:]) + timing["drain_s"]

        # PPL's two images share their noise: at ε = 0 the distance is 0
        G = build_generator(g_cfg, g_pth).to("cuda").eval()
        G.requires_grad_(False)
        gen = torch.Generator().manual_seed(5)
        real = torch.from_numpy(np.stack(reals[:batch]).transpose(0, 3, 1, 2)
                                ).float().cuda() / 127.5 - 1
        mask = (torch.rand(batch, 1, FULL_RES, FULL_RES, generator=gen)
                > 0.3).float().cuda()
        x = torch.cat([mask - 0.5, real * mask], dim=1)
        z = torch.randn(2 * batch, G.z_dim, generator=gen).cuda()
        zero = torch.zeros(batch, device="cuda")
        lp = lpips_params_to(random_vgg16_lpips_params(0), "cuda")
        d0 = make_ppl_sampler(G, lp, 0.0, "w", "end", False,
                              net="vgg16").distance(x, z[:batch], z[batch:],
                                                    zero, 77)
        d_step = make_ppl_sampler(G, lp, ppl_cfg["epsilon"], "w", "end",
                                  False, net="vgg16")(
            x, z[:batch], z[batch:], zero, 77)
        if not torch.equal(d0, torch.zeros_like(d0)):
            raise AssertionError(f"PPL at eps 0: {d0.tolist()}")
        if not (torch.isfinite(d_step).all() and (d_step > 0).all()):
            raise AssertionError(f"PPL at eps {ppl_cfg['epsilon']}: "
                                 f"{d_step.tolist()}")
        del G

        # again, the real features from the cache the first run wrote
        cache = os.path.join(work, "cache")
        if not os.listdir(cache):
            raise AssertionError("no real-feature cache written")
        ccfg = fullmetrics_config(work, g_pth, data_root, "log_cached",
                                  evaluators=("fid", "kid", "pr", "is"))
        t0 = time.perf_counter()
        crv = cli.run(ccfg)
        cached_s = time.perf_counter() - t0
        cached = {"fid": crv["eval_rv"]["fid"], "kid": crv["eval_rv"]["kid"],
                  "precision": crv["eval_rv"]["pr"]["precision"],
                  "recall": crv["eval_rv"]["pr"]["recall"]}
        cached_diff = {k: abs(cached[k] - metrics[k]) for k in cached}
        if not all(cached_diff[k] <= CACHED_RTOL * abs(metrics[k])
                   for k in cached):
            raise AssertionError(f"cached run: {cached} against {metrics}")

        # the pre-generated protocol: each real flipped left to right
        gen_dir = os.path.join(work, "gen")
        os.makedirs(gen_dir)
        for i, img in enumerate(reals):
            Image.fromarray(np.ascontiguousarray(img[:, ::-1])).save(
                os.path.join(gen_dir, f"{i:05d}.png"))
        from shgan_torch.main import build_config
        pcfg = build_config("shgan_ffhq256_eval", eval_id=0,
                            pretrained=g_pth, evalnog_path=gen_dir,
                            log_root=os.path.join(work, "log_pregen"))
        pev = pcfg["eval"]
        pev["dataset"]["root_dir"] = data_root
        pev["dataset"]["try_sample"] = PREGEN_IMAGES
        pev["evaluator"] = [
            dict(e, args=dict(e.get("args") or {},
                              cache_dir=os.path.join(work, "cache_pregen")))
            for e in pev["evaluator"]] + [
            {"type": "psnr", "args": {"for_dataset": None, "rgb_range": 1}},
            {"type": "ssim", "args": {"window_size": 11}}]
        build.reset_launches()
        t0 = time.perf_counter()
        prv = cli.run(pcfg)["eval_rv"]
        pregen_s = time.perf_counter() - t0
        pregen_launches = dict(build.launches)
        pregen = {"fid": prv["fid"], "psnr": prv["psnr"],
                  "ssim": prv["ssim"]}
        if (any(pregen_launches.values())
                or pcfg["eval"]["dataset"]["type"] != "ffhqzip_loadgen"
                or not all(math.isfinite(v) for v in pregen.values())):
            raise AssertionError(f"pregen: {pregen}, launches "
                                 f"{pregen_launches}")

        # the same protocol through the command line, data under the cwd
        cli_env = dict(os.environ, SHGAN_LOG_ROOT=os.path.join(work, "cli"),
                       PYTHONPATH=os.pathsep.join(
                           [os.path.dirname(os.path.abspath(__file__))]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "shgan_torch.main", "--experiment",
             "shgan_ffhq256_eval", "--eval", "0", "--evalnog_path", gen_dir,
             "--pretrained", g_pth], cwd=work, env=cli_env,
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"CLI --evalnog_path exit {r.returncode}:\n"
                                 f"{r.stdout}\n{r.stderr}")
        res_json = os.path.join(work, "cli", "shgan_ffhqzip_val256_inpainting",
                                "0", "shgan_ffhq256", "result.json")
        with open(res_json) as f:
            cli_fid = json.load(f)["fid"]["fid"]
        if not math.isfinite(cli_fid):
            raise AssertionError(f"CLI --evalnog_path fid {cli_fid}")
        cli_s = time.perf_counter() - t0
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    row = {"phase": "fullmetrics_path", "experiment": FULL_EXPERIMENT,
           "model": g_cfg.get("name"), "images": FULL_IMAGES,
           "batch": batch, "resolution": FULL_RES, "noise_mode": "random",
           "cudnn_tf32": torch.backends.cudnn.allow_tf32,
           "evaluators": [e["type"] for e in ev["evaluator"]],
           "ppl": {k: ppl_cfg[k] for k in ("num_samples", "epsilon", "space",
                                           "sampling", "batch_size")},
           "ppl_net": "vgg16", "metrics": metrics,
           "launches": launches, "k2_launches_by_route": tally,
           "expected": rule,
           "stream_images_per_s": batch * (rule["stream_forwards"] - 1)
           / stream_s,
           "images_timed": batch * (rule["stream_forwards"] - 1),
           "batch_s": timing["batch_s"], "drain_s": timing["drain_s"],
           "ppl_s": timing["generator_metrics_s"],
           "ppl_samples_per_s": ppl_cfg["num_samples"]
           / timing["generator_metrics_s"],
           "run_s": run_s, "peak_mem_gib": peak_gib,
           "ppl_eps0_distance": d0.tolist(),
           "ppl_step_distance": d_step.tolist(),
           "cached": cached, "cached_abs_diff": cached_diff,
           "cached_rtol": CACHED_RTOL,
           "cached_images_per_s": batch * (rule["stream_forwards"] - 1)
           / (sum(crv["timing"]["batch_s"][1:]) + crv["timing"]["drain_s"]),
           "cached_run_s": cached_s,
           "pregen": pregen, "pregen_images": PREGEN_IMAGES,
           "pregen_launches": pregen_launches, "pregen_s": pregen_s,
           "cli_evalnog": {"argv": r.args[1:], "exit": r.returncode,
                           "fid": cli_fid, "images": FULL_IMAGES,
                           "wall_s": cli_s},
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# training as configured: shgan_ffhq256_train with a schedule, a registry
# optimizer, the nested FID eval, -best, the profiler; export and reload
# ---------------------------------------------------------------------------

CONFIG_TRAIN_STEPS = 12       # total_kimg 0.096 at batch 8
CONFIG_TICK_STEPS = 3         # kimg_per_tick 0.024
CONFIG_VAL, CONFIG_TRAIN = 64, 96   # FFHQ-format images in the zip
NESTED_FORWARDS = 4           # 64 nested eval images at batch 16
WARMUP_STEPS = 4              # g_opt's linear warm-up, 0 -> G_LR
G_LR = 0.002


def ffhq_split_zip(root, res, seed=0):
    """``<root>/data/ffhq/ffhq256x256.zip`` holding the CoModGAN split as
    the ``ffhqzip`` reader cuts it (val = the first 10000 uids in sorted
    order, train the rest): ``CONFIG_VAL`` val images ``00000`` …,
    ``CONFIG_TRAIN`` train images ``10000`` …, and between them the
    remaining val names, all one flat gray PNG that no run here decodes;
    returns the directory holding the zip."""
    from PIL import Image
    import io
    import zipfile
    d = os.path.join(root, "data", "ffhq")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)

    def png(img):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return buf.getvalue()

    def image():
        low = torch.from_numpy(rng.rand(1, 3, 8, 8).astype(np.float32))
        img = F.interpolate(low, size=(res, res), mode="bicubic",
                            align_corners=False)[0].numpy()
        img = img + 0.05 * rng.randn(3, res, res).astype(np.float32)
        return png(np.rint(np.clip(img, 0, 1) * 255).astype(np.uint8)
                   .transpose(1, 2, 0))

    gray = png(np.full((res, res, 3), 128, np.uint8))
    with zipfile.ZipFile(os.path.join(d, "ffhq256x256.zip"), "w") as z:
        for i in range(10000):
            z.writestr(f"{i:05d}.png", image() if i < CONFIG_VAL else gray)
        for i in range(10000, 10000 + CONFIG_TRAIN):
            z.writestr(f"{i:05d}.png", image())
    return d


def reference_pickle(G, path):
    """Write ``G`` as the reference's train stage writes a snapshot: a
    plain pickle of ``{"G": None, "D": None, "G_ema": <module>,
    "augment_pipe": None}`` with whole torch modules, each of a class named
    as the reference's model zoo (``lib.model_zoo.comodgan.<class>``)
    holding the parameters and persistent buffers of ``G``'s module at the
    same path, on the CPU."""
    import pickle
    import types
    zoo = "lib.model_zoo.comodgan"
    for name in ("lib", "lib.model_zoo", zoo):
        sys.modules.setdefault(name, types.ModuleType(name))
    mod = sys.modules[zoo]
    keep = set(G.state_dict())

    def mirror(m, prefix):
        cls_name = type(m).__name__
        if not hasattr(mod, cls_name):
            setattr(mod, cls_name, type(cls_name, (torch.nn.Module,),
                                        {"__module__": zoo,
                                         "__qualname__": cls_name}))
        out = getattr(mod, cls_name)()
        for n, p in m.named_parameters(recurse=False):
            if prefix + n in keep:
                out.register_parameter(n, torch.nn.Parameter(
                    p.detach().cpu().clone(), requires_grad=False))
        for n, b in m.named_buffers(recurse=False):
            if prefix + n in keep:
                out.register_buffer(n, b.detach().cpu().clone())
        for n, c in m.named_children():
            out.add_module(n, mirror(c, f"{prefix}{n}."))
        return out

    with open(path, "wb") as f:
        pickle.dump({"G": None, "D": None, "G_ema": mirror(G, ""),
                     "augment_pipe": None}, f)
    return path


def config_train_config(tmp, data_root, inc_pth):
    """``shgan_ffhq256_train`` through the CLI's config assembly as
    configured (``shgan_g256`` + ``comodgan_d256``, float32, batch 8, the
    configured loss kwargs, ``ffhqzip`` train and val datasets), with 12
    steps in ticks of 3, a snapshot every 2 ticks, a nested FID over 64 val
    images each tick, ``g_opt`` on a linear warm-up schedule, ``d_opt`` the
    registry's Adam, and the profiler's trace."""
    from shgan_torch.main import build_config
    cfg = build_config(
        TRAIN_EXPERIMENT, log_root=os.path.join(tmp, "log"),
        overrides={
            "train.experiment_id": 0,
            "train.total_kimg": CONFIG_TRAIN_STEPS * TRAIN_BATCH / 1000,
            "train.kimg_per_tick": CONFIG_TICK_STEPS * TRAIN_BATCH / 1000,
            "train.snapshot_ticks": 2,
            "train.eval_every_kimg": CONFIG_TICK_STEPS * TRAIN_BATCH / 1000,
            "train.profile_dir": os.path.join(tmp, "profile"),
            "train.dataset.root_dir": data_root,
            "eval.dataset.root_dir": data_root,
            "eval.nested_eval_metric": "fid",
            "eval.nested_eval_samples": CONFIG_VAL})
    lk = cfg["train"]["loss_kwargs"]
    lk["g_opt"] = {"schedule": [
        {"type": "linear", "args": {"start_lr": 0.0, "end_lr": G_LR,
                                    "step": WARMUP_STEPS}},
        {"type": "constant", "args": {"lr": G_LR, "step": 1000}}]}
    lk["d_opt"] = {"optimizer": {"type": "adam",
                                 "args": {"betas": [0.0, 0.99]}}}
    for e in cfg["eval"]["evaluator"]:
        if e["type"] == "fid":
            e["args"] = dict(e.get("args") or {}, detector_weights=inc_pth)
    return cfg


def expected_lrs(tc, step_i):
    """(G's, D's) LR of update ``step_i``, worked out here: the warm-up in
    float32 as JAX's traced schedule computes it, times the
    lazy-regularization ratio in float32; D's registry Adam at the
    default LR times its ratio."""
    f32 = np.float32
    rg = f32(tc.g_reg_interval / (tc.g_reg_interval + 1))
    if step_i < WARMUP_STEPS:
        s = f32(G_LR) + f32(0.0 - G_LR) * (f32(1) - f32(step_i)
                                            / f32(WARMUP_STEPS))
    else:
        s = f32(G_LR)
    return float(s * rg), 0.002 * (tc.d_reg_interval
                                   / (tc.d_reg_interval + 1))


def trace_top_ops(path, n=10):
    """→ (count of each phase span, the ``n`` device ops with the most
    time, the device ms in all, the device ops in all) of a Chrome trace,
    counting the device ops whose launch lies inside a phase span."""
    import bisect
    from shgan_torch.train import TrainStep
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in TrainStep.PHASES]
    counts = {k: sum(e.get("cat") == "user_annotation"
                     and e.get("name") == k for e in events)
              for k in TrainStep.PHASES}
    spans.sort()
    starts = [s for s, _ in spans]

    def inside(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= spans[i][1]

    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {}) and inside(e["ts"])}
    by_name, n_ops = {}, 0
    for e in events:
        if (e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                and e.get("args", {}).get("correlation") in launched):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
            n_ops += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return (counts, [{"op": k[:120], "ms": v / 1e3} for k, v in top],
            sum(by_name.values()) / 1e3, n_ops)


def train_config_path(tmp, cli, build, fir, inc_pth):
    """``shgan_ffhq256_train`` as configured on the card: 12 steps on an
    FFHQ-format zip, the LRs of every update, launches in and outside every
    step (the nested evals' K2 calls by route), four nested FIDs with the
    run-local real-feature cache, the ``-best`` snapshot, the profiler's
    three-step trace; then the best G_ema exported with ``python -m
    shgan_torch.export_pth``, evaluated strictly, and loaded again from a
    reference-format ``.pkl`` and from the ``.pth`` with equal
    composites."""
    from shgan_torch.eval import detector
    from shgan_torch.models.infer import composite_forward
    from shgan_torch.runtime import stages
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "train_config")
    os.makedirs(work)
    data_root = ffhq_split_zip(work, FULL_RES)
    cfg = config_train_config(work, data_root, inc_pth)
    log_dir = cfg["train"]["log_dir"]
    g_cfg = cfg["model_g"]
    eval_batch = cfg["eval"]["batch_size_per_gpu"]
    per_fwd = fullmetrics_launches(g_cfg, eval_batch, 0, 0, 1)
    fwd_k2 = per_fwd["upfirdn2d_per_forward"]
    layers = per_fwd["noise_bias_act_per_forward"]
    convs = per_fwd["bias_lrelu_per_forward"]

    # the TrainStep the stage builds, its LRs and launches around each step
    seen, lrs, per_step, outside, out_route, inception = [], [], [], [], [], []
    init = {}
    moved = {}
    real_passes = [0]

    class Recorded(stages.TrainStep):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    orig_run = detector.InceptionDetector._run

    def counted_run(self, x, want_probs):
        real_passes[0] += 1
        return orig_run(self, x, want_probs)

    tally, undo = fir_route_tally(fir)
    cache = os.path.join(log_dir, ".cache")
    cache_state = []

    def cache_digest():
        files = sorted(os.listdir(cache)) if os.path.isdir(cache) else []
        return [(f, os.stat(os.path.join(cache, f)).st_mtime_ns,
                 hash(open(os.path.join(cache, f), "rb").read()))
                for f in files]

    def on_step_start(i):
        outside.append(dict(build.launches))
        out_route.append(dict(tally))
        inception.append(real_passes[0])
        build.reset_launches()
        tally.update({k: 0 for k in tally})
        real_passes[0] = 0
        cache_state.append(cache_digest())
        if i == 0:
            init.update({k: v.detach().clone()
                         for k, v in seen[0].G.named_parameters()})

    def on_step(i, metrics):
        per_step.append(dict(build.launches))
        build.reset_launches()
        tally.update({k: 0 for k in tally})
        st = seen[0]
        lrs.append(([g["lr"] for g in st.opt_g.param_groups],
                    [g["lr"] for g in st.opt_d.param_groups]))
        if i in (0, 1):
            moved[i] = max(float((p.detach() - init[k]).abs().max())
                           for k, p in st.G.named_parameters())

    env = {"SHGAN_TPU_INCEPTION": inc_pth}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    train_step_cls = stages.TrainStep
    stages.TrainStep = Recorded
    detector.InceptionDetector._run = counted_run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        rv = cli.run(cfg, on_step=on_step, on_step_start=on_step_start)
        outside.append(dict(build.launches))
        out_route.append(dict(tally))
        inception.append(real_passes[0])
        cache_state.append(cache_digest())
    finally:
        undo()
        stages.TrainStep = train_step_cls
        detector.InceptionDetector._run = orig_run
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    run_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step = rv["step"]
    tc = step.cfg
    n = CONFIG_TRAIN_STEPS
    checks = {}

    # 12 steps, finite losses, the LR of every update
    if len(per_step) != n or step.step != n:
        raise AssertionError(f"{len(per_step)} steps run")
    for t in rv["ticks"]:
        for k in ("loss_g", "loss_d"):
            if not math.isfinite(t[k]):
                raise AssertionError(f"tick {t['tick']}: {k} = {t[k]}")
    want_lrs = [expected_lrs(tc, i) for i in range(n)]
    for i, ((g, d), (wg, wd)) in enumerate(zip(lrs, want_lrs)):
        if any(v != wg for v in g) or any(v != wd for v in d):
            raise AssertionError(f"step {i} LRs G {g} D {d}, expected "
                                 f"{wg} / {wd}")
    checks["lrs"] = [[g[0], d[0]] for g, d in lrs]
    if moved[0] != 0 or not moved[1] > 0:
        raise AssertionError(f"G moved {moved} at steps 0 and 1 (LR 0, "
                             "then > 0)")
    emit({"phase": "train_config_check", "check": "lrs_and_losses",
          "steps": n, "lr_g_d": checks["lrs"], "g_max_move": moved})

    # launches in every step, and outside: grids (3 forwards) and nested
    # evals (4 forwards) of shgan_g256 at batch 16, nothing else
    sites = train_sites(step.G, step.D)
    for i, got in enumerate(per_step):
        want = expected_train_launches(*sites, i % tc.g_reg_interval == 0,
                                       i % tc.d_reg_interval == 0)
        if got != want:
            raise AssertionError(f"train step {i} launches {got}, "
                                 f"expected {want}")
    ticks_at = {CONFIG_TICK_STEPS * (t + 1) for t in range(
        n // CONFIG_TICK_STEPS)}
    image_ticks = cfg["train"]["snapshot_ticks"]
    want_out = []
    for w in range(n + 1):      # window w: before step w (w = n: the end)
        evals = int(w in ticks_at)
        grids = (int(w == 0) + int(w in ticks_at and (w // CONFIG_TICK_STEPS)
                                   % image_ticks == 0) + int(w == n))
        fwd = NESTED_FORWARDS * evals + GRID_FORWARDS * grids
        row = {k: 0 for k in build.launches}
        row.update(upfirdn2d=fwd * sum(fwd_k2.values()),
                   noise_bias_act=fwd * layers, bias_lrelu=fwd * convs)
        want_out.append((row, {"stride1": fwd * fwd_k2["stride1"],
                               "up2": fwd * fwd_k2["up2"], "other": 0}))
    got_out = list(zip(outside, out_route))
    if got_out != want_out:
        raise AssertionError(f"launches outside the steps {got_out}, "
                             f"expected {want_out}")
    emit({"phase": "train_config_check", "check": "launches",
          "per_step": per_step, "outside_windows": outside,
          "outside_k2_by_route": out_route,
          "nested_eval_forwards": NESTED_FORWARDS, "eval_batch": eval_batch})

    # four finite nested FIDs; the real-feature cache written by the first
    # eval, then read unchanged (one Inception pass a batch, the fakes')
    stats = [json.loads(line) for line in open(os.path.join(
        log_dir, "stats.jsonl"))]
    fids = [r["eval_fid"] for r in stats if "eval_fid" in r]
    if len(fids) != 4 or not all(math.isfinite(v) for v in fids):
        raise AssertionError(f"stats.jsonl eval_fid {fids}")
    eval_windows = sorted(ticks_at)
    passes = [inception[w] for w in eval_windows]
    if passes != [2 * NESTED_FORWARDS] + [NESTED_FORWARDS] * 3:
        raise AssertionError(f"Inception passes per nested eval {passes}")
    first = cache_state[eval_windows[0]]
    if (cache_state[eval_windows[0] - 1] or not first
            or any(cache_state[w] != first for w in eval_windows)):
        raise AssertionError(f"real-feature cache {cache_state}")
    emit({"phase": "train_config_check", "check": "nested_fid",
          "eval_fid": fids, "inception_passes": passes,
          "cache": [f for f, _, _ in first]})

    # -best: one "new best" line per strict improvement
    best, n_best = None, 0
    for v in fids:
        if best is None or v < best:
            best, n_best = v, n_best + 1
    log_lines = open(os.path.join(log_dir, "train.log")).read().splitlines()
    got_best = sum(line.startswith("new best fid=") for line in log_lines)
    best_dir = os.path.join(log_dir, "weight", "network-snapshot-best")
    if got_best != n_best or not os.path.isfile(
            os.path.join(best_dir, "state.pt")):
        raise AssertionError(f"{got_best} new-best lines, {n_best} strict "
                             f"improvements in {fids}")
    emit({"phase": "train_config_check", "check": "best",
          "new_best_lines": got_best, "improvements": n_best})

    # the profiler's trace of steps 8-10
    traces = os.listdir(cfg["train"]["profile_dir"])
    if traces != ["train_steps000008-000010.json"]:
        raise AssertionError(f"profiler traces {traces}")
    span_counts, top_ops, traced_ms, traced_ops = trace_top_ops(
        os.path.join(cfg["train"]["profile_dir"], traces[0]))
    if span_counts["Gmain"] != 3 or span_counts["Dmain"] != 3:
        raise AssertionError(f"trace spans {span_counts}")
    emit({"phase": "train_config_check", "check": "profile",
          "trace": traces[0], "spans": span_counts,
          "device_ms_in_spans": traced_ms, "device_ops_in_spans": traced_ops,
          "top_device_ops": top_ops})

    # export the best G_ema, evaluate it strictly, reload it through a
    # reference-format .pkl and through the .pth
    best_pth = os.path.join(work, "best.pth")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "shgan_torch.export_pth", "--snapshot",
         best_dir, "--out", best_pth], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in [os.environ.get("PYTHONPATH")] if p])))
    export_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"export_pth exit {r.returncode}:\n{r.stdout}"
                             f"\n{r.stderr}")
    from shgan_torch.main import build_config
    ecfg = build_config(TRAIN_EXPERIMENT, eval_id=0, pretrained=best_pth,
                        log_root=os.path.join(work, "log_eval"))
    ev = ecfg["eval"]
    ev["dataset"]["root_dir"] = data_root
    ev["dataset"]["try_sample"] = CONFIG_VAL
    ev["strict_sd"] = True
    ev["log_display"] = CONFIG_VAL
    ev["evaluator"] = [
        {"type": "fid", "args": {"detector_weights": inc_pth,
                                 "cache_dir": os.path.join(work, "cache")}},
        {"type": "psnr", "args": {"for_dataset": None, "rgb_range": 1}},
        {"type": "ssim", "args": {"window_size": 11}}]
    t0 = time.perf_counter()
    erv = cli.run(ecfg)["eval_rv"]
    eval_s = time.perf_counter() - t0
    exported = {"fid": erv["fid"], "psnr": erv["psnr"], "ssim": erv["ssim"]}
    if not all(math.isfinite(v) for v in exported.values()):
        raise AssertionError(f"exported G_ema's eval: {exported}")

    pkl = reference_pickle(stages.build_generator(g_cfg, best_pth),
                           os.path.join(work, "network-snapshot-000096.pkl"))
    t0 = time.perf_counter()
    with cudnn_flags(deterministic=True):
        outs = []
        gen = torch.Generator().manual_seed(3)
        real = torch.rand(eval_batch, 3, FULL_RES, FULL_RES,
                          generator=gen) * 2 - 1
        mask = (torch.rand(eval_batch, 1, FULL_RES, FULL_RES,
                           generator=gen) > 0.5).float()
        z = torch.randn(eval_batch, step.G.z_dim, generator=gen)
        for path in (pkl, best_pth):
            G = stages.build_generator(g_cfg, path).cuda().eval()
            with torch.inference_mode():
                outs.append(composite_forward(G, real.cuda(), mask.cuda(),
                                              z.cuda(), noise_mode="const"))
            del G
    reload_s = time.perf_counter() - t0
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("the .pkl and .pth composites differ: max "
                             f"{(outs[0].int() - outs[1].int()).abs().max()}")
    emit({"phase": "train_config_check", "check": "export_reload",
          "export_exit": r.returncode, "exported_eval": exported,
          "pkl_equals_pth": True, "composite_shape": list(outs[0].shape)})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    step_ms = [s * 1e3 for s in rv["timing"]["step_s"]]
    traced = set(range(stages.PROFILE_AT, stages.PROFILE_AT + 3))
    timed = [i for i in range(1, n) if i not in traced]
    row = {"phase": "train_config_path", "experiment": TRAIN_EXPERIMENT,
           "card": smi, "model_g": g_cfg.get("name"),
           "model_d": cfg["model_d"].get("name"),
           "dataset": cfg["train"]["dataset"]["name"],
           "eval_dataset": cfg["eval"]["dataset"]["name"],
           "batch": TRAIN_BATCH, "steps": n,
           "step_ms": step_ms, "timed_steps": timed,
           "images_per_s_untraced": TRAIN_BATCH * len(timed)
           / (sum(step_ms[i] for i in timed) / 1e3),
           "nested_eval_s": rv["timing"]["nested_eval_s"],
           "export_s": export_s, "exported_eval_s": eval_s,
           "reload_s": reload_s, "run_s": run_s, "peak_mem_gib": peak_gib,
           "eval_fid": fids, "exported_eval": exported,
           "launches_per_step": per_step, "launches_outside": outside,
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    del step, rv, seen
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the bf16 throughput configuration: serving, generate, training, StyleGAN2
# ---------------------------------------------------------------------------

# tests/test_bf16_quality.py:24-26: the bf16 composite against float32
BF16_GATE = {"max_u8_delta": 16, "min_psnr": 45.0, "min_ssim": 0.995,
             "max_frac_gt2": 0.02}
# the JAX package's record of the same comparison, measured on a TPU
# (docs/perf_ab.json:84-88), printed beside the card's for reference only
TPU_BF16_RECORD = {"max_u8_delta": 9, "psnr": 53.43, "ssim": 0.99993,
                   "frac_gt2": 0.01269, "where": "TPU v5e (JAX package)"}
GEN_IMAGES = 64
BF16_1024_BATCH = 4
SG2_MODEL, SG2_D = "stylegan2_generator_256", "stylegan2_discriminator_256"
SG2_ATOL = 1e-3       # StyleGAN2 image, card vs CPU, float32, TF32 off
# the CPU test's bound on the port's bf16 error over another bf16
# computation's (tests/test_torch_bf16.py: 2x, measured at most 1.64x)
BF16_RATIO = 2.0


def bf16_gate(got, ref):
    """The GATE's four numbers of a uint8 NCHW composite against the
    float32 one."""
    from shgan_torch.eval.ssim import compute_ssim
    g, r = got.astype(np.int64), ref.astype(np.int64)
    delta = np.abs(g - r)
    mse = float(((g - r) ** 2).mean()) / 255 ** 2
    return {"max_u8_delta": int(delta.max()),
            "psnr": math.inf if mse == 0 else -10 * math.log10(mse),
            "ssim": float(compute_ssim(torch.from_numpy(ref),
                                       torch.from_numpy(got)).mean()),
            "frac_gt2": float((delta > 2).mean())}


def gate_holds(g):
    return (g["max_u8_delta"] <= BF16_GATE["max_u8_delta"]
            and g["psnr"] >= BF16_GATE["min_psnr"]
            and g["ssim"] >= BF16_GATE["min_ssim"]
            and g["frac_gt2"] <= BF16_GATE["max_frac_gt2"])


def forward_launches(G, encoder=True):
    """(all launches, bf16 launches) of one generator forward: K2 at every
    resampling site, the fused epilogue at every synthesis layer and
    bias_lrelu at every conv epilogue of the encoder."""
    mods = ([G.encoder] if encoder else []) + [G.synthesis]
    allk = [sites_of(m)[:2] + (conv_sites(m),) for m in mods]
    bfk = [sites_of(m, torch.bfloat16)[:2]
           + (conv_sites(m, torch.bfloat16),) for m in mods]
    want = {k: 0 for k in ("upfirdn2d", "upfirdn2d_grad", "philox_normal",
                           "conv3x3_lowch", "noise_bias_act",
                           "noise_bias_act_grad", "bias_lrelu")}
    want.update(upfirdn2d=sum(k for k, _, _ in allk),
                noise_bias_act=sum(n for _, n, _ in allk),
                bias_lrelu=sum(c for _, _, c in allk))
    want16 = dict.fromkeys(BF16_KEYS, 0)
    want16.update(upfirdn2d=sum(k for k, _, _ in bfk),
                  noise_bias_act=sum(n for _, n, _ in bfk),
                  bias_lrelu=sum(c for _, _, c in bfk))
    return want, want16


def modconv_counts(blocks, casts=0):
    """The modulated convs' counts (``build.modconv``) of one no-grad
    forward of a co-modulated synthesis of ``blocks`` levels (4² up):
    every modulated conv but ``b4.conv`` takes an input its producer's
    epilogue scaled (the fold), except at each of ``casts`` levels whose
    type differs from the level before (bf16 after float32), where the
    ``torgb`` before it and its ``conv0`` multiply for themselves."""
    multiplied = 1 + 2 * casts
    return {"prescaled": 3 * blocks - 1 - multiplied,
            "multiplied": multiplied}


def synthesis_modconv(syn):
    """:func:`modconv_counts` of the synthesis module ``syn``."""
    dts = [torch.float32] + [getattr(syn, f"b{r}").dtype
                             for r in syn.block_res[1:]]
    return modconv_counts(len(dts), sum(a != b for a, b in zip(dts,
                                                              dts[1:])))


def train_modconv(syn, greg, accum=1):
    """The modulated convs' counts (``build.modconv``) of one training step
    of a co-modulated synthesis ``syn`` (no remat): each round's Gmain and
    Gpl (``greg``) forwards record a gradient and multiply in every conv;
    its D-phase generator forward runs under ``no_grad`` and takes the
    route (:func:`synthesis_modconv`)."""
    d = synthesis_modconv(syn)
    convs = sum(d.values())
    a = max(int(accum), 1)
    return {"prescaled": a * d["prescaled"],
            "multiplied": a * ((2 if greg else 1) * convs
                               + d["multiplied"])}


def counted(build, fn):
    """``fn()`` with the launch counts (all, bf16) set to 0 before it and
    read after it."""
    build.reset_launches()
    reset_bf16_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.launches), dict(bf16_launches)


def add_launches(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


@contextmanager
def library_conv(*engines):
    """The library conv (cuDNN) in K3's place inside the block: the route's
    predicate in ``ops/conv_resample`` patched to refuse K3.  A graph
    replays the route it was captured with, so ``engines``' graphs are
    freed on entering the block and on leaving it."""
    from shgan_torch.ops import conv_resample
    held = conv_resample.takes_k3
    for e in engines:
        e.close()
    conv_resample.takes_k3 = lambda *a, **k: False
    try:
        yield
    finally:
        conv_resample.takes_k3 = held
        for e in engines:
            e.close()


def bf16_serving(build, total):
    """The bf16 engine against the float32 engine on the same random weights
    and requests (noise const, the float32 reference with TF32 off):
    ``shgan_g512`` at batch 8, held to the GATE; then one ``shgan_g1024``
    request at batch 4 with K3 on, its two 1024² blocks in bf16 (K3's bf16
    route): launches exact, known pixels exact, SSIM within the GATE, and
    the GATE's four numbers recorded against float32 and against the same
    bf16 engine with its route swapped for cuDNN (:func:`library_conv`).
    The GATE was set and measured at
    512² (the JAX package, on a TPU); with random weights ``shgan_g1024``
    turns a one-ulp change at an early 1024² layer into 5–7 % of its
    pixels off by more than 2 (K3 or cuDNN alike), so at 1024² it is
    recorded, not held.  Steady images/s of both engines in turns
    (cuDNN's defaults, as served)."""
    from shgan_torch.serve import InpaintEngine
    rows = {}
    for model, batch, k3 in ((MODEL, SERVE_BATCH, False),
                             (MODEL_1024, BF16_1024_BATCH, True)):
        kw = dict(device="cuda", batch_size=batch, noise_mode="const",
                  seed=0)
        t0 = time.perf_counter()
        e32, e16 = InpaintEngine(model, **kw), InpaintEngine(model, bf16=True,
                                                             **kw)
        setup_s = time.perf_counter() - t0
        for e in (e32, e16):
            noise_reaches_image(e.G)
        res = e32.G.img_resolution
        rng = np.random.RandomState(batch)
        imgs = rng.randint(0, 256, (batch, 3, res, res), dtype=np.uint8)
        masks = (rng.rand(batch, res, res) > 0.5).astype(np.float32)
        want, want16 = forward_launches(e16.G)
        if k3:   # the engines route the 1024² low-channel convs to K3
            want["conv3x3_lowch"] = 2
        torch.backends.cudnn.allow_tf32 = False
        try:
            out32 = e32.inpaint(imgs, masks)
            e16.inpaint(imgs, masks)   # first use: set-up
            out16, launches, l16 = counted(
                build, lambda: e16.inpaint(imgs, masks))
            if k3:   # the same bf16 engine on cuDNN's convolution
                with library_conv(e16):
                    out16_cudnn = e16.inpaint(imgs, masks)
            torch.backends.cudnn.allow_tf32 = True
            ips = {"float32": [], "bf16": []}
            for name, e in (("float32", e32), ("bf16", e16), ("bf16", e16),
                            ("float32", e32)):
                e.inpaint(imgs, masks)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(5):
                    e.inpaint(imgs, masks, start_index=batch * i)
                torch.cuda.synchronize()
                ips[name].append(5 * batch / (time.perf_counter() - t0))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        add_launches(total, launches)
        if launches != want or l16 != want16:
            raise AssertionError(f"bf16 {model} launches {launches} / bf16 "
                                 f"{l16}, expected {want} / {want16}")
        if out16.shape != imgs.shape or out16.dtype != np.uint8:
            raise AssertionError(f"bf16 output {out16.shape} {out16.dtype}")
        gate = dict(bf16_gate(out16, out32))
        gate["holds"] = gate_holds(gate)
        keep = np.broadcast_to(masks[:, None] > 0.5, out16.shape)
        known = bool(np.array_equal(out16[keep], quantized(imgs)[keep]))
        row = {"model": model, "batch": batch, "noise_mode": "const",
               "gate": gate, "gate_limits": BF16_GATE,
               "gate_k3_vs_cudnn": (dict(bf16_gate(out16, out16_cudnn))
                                    if k3 else None),
               "known_pixels_exact": known,
               "tpu_record": TPU_BF16_RECORD if model == MODEL else None,
               "launches": launches, "bf16_launches": l16,
               "steady_images_per_s": ips, "setup_s": setup_s,
               "k3": k3}
        rows[model] = row
        emit(dict(row, phase="bf16_serving"))
        blocks = [e16.G.encoder, e16.G.synthesis]
        if not known or (not k3 and not gate["holds"]) or (k3 and not (
                gate["ssim"] >= BF16_GATE["min_ssim"]
                and row["gate_k3_vs_cudnn"]["ssim"] >= BF16_GATE["min_ssim"]
                and all(getattr(b, f"b{res}").dtype == torch.bfloat16
                        for b in blocks))):
            raise AssertionError(f"bf16 serving at {model}: {row}")
        e32.close()
        e16.close()
        del e32, e16
        torch.cuda.empty_cache()
    return rows


def bf16_generate(tmp, cli, build, inc_pth):
    """``python -m shgan_torch.generate --bf16`` over the first 64 images of
    an FFHQ-format zip (full-width ``shgan_g256``, random weights), then
    the directory scored with no generator: in process (psnr, ssim; no
    launch) and through ``python -m shgan_torch.main --evalnog_path``."""
    from shgan_torch.main import build_config
    work = os.path.join(tmp, "bf16_gen")
    data_root, _ = ffhq_zip(work, GEN_IMAGES, FULL_RES, seed=2)
    g_pth = os.path.join(work, f"{FULL_G}_random.pth")
    random_weights(FULL_G, g_pth, seed=3)
    gen_dir = os.path.join(work, "gen")
    env = dict(os.environ, SHGAN_LOG_ROOT=os.path.join(work, "cli"),
               SHGAN_TPU_INCEPTION=inc_pth,
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.abspath(__file__))]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "shgan_torch.generate", "--experiment",
         "shgan_ffhq256_eval", "--bf16", "--out", gen_dir, "--n",
         str(GEN_IMAGES), "--pretrained", g_pth], cwd=work, env=env,
        capture_output=True, text=True, timeout=600)
    gen_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"generate exit {r.returncode}:\n{r.stdout}\n"
                             f"{r.stderr}")
    names = sorted(os.listdir(gen_dir))
    if names != [f"{i:05d}.png" for i in range(GEN_IMAGES)]:
        raise AssertionError(f"generate wrote {len(names)} files: "
                             f"{names[:3]}...")
    pcfg = build_config("shgan_ffhq256_eval", eval_id=0, evalnog_path=gen_dir,
                        log_root=os.path.join(work, "log_pregen"))
    pev = pcfg["eval"]
    pev["dataset"]["root_dir"] = data_root
    pev["dataset"]["try_sample"] = GEN_IMAGES
    pev["evaluator"] = [
        {"type": "psnr", "args": {"for_dataset": None, "rgb_range": 1}},
        {"type": "ssim", "args": {"window_size": 11}}]
    (rv, launches, _) = counted(build, lambda: cli.run(pcfg)["eval_rv"])
    metrics = {"psnr": rv["psnr"], "ssim": rv["ssim"]}
    if any(launches.values()) or not all(math.isfinite(v)
                                         for v in metrics.values()):
        raise AssertionError(f"pregen of the generated dir: {metrics}, "
                             f"launches {launches}")
    t0 = time.perf_counter()
    c = subprocess.run(
        [sys.executable, "-m", "shgan_torch.main", "--experiment",
         "shgan_ffhq256_eval", "--eval", "0", "--evalnog_path", gen_dir],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if c.returncode != 0:
        raise AssertionError(f"CLI --evalnog_path exit {c.returncode}:\n"
                             f"{c.stdout}\n{c.stderr}")
    with open(os.path.join(work, "cli", "shgan_ffhqzip_val256_inpainting",
                           "0", "shgan_ffhq256", "result.json")) as f:
        fid = json.load(f)["fid"]["fid"]
    if not math.isfinite(fid):
        raise AssertionError(f"CLI --evalnog_path fid {fid}")
    shutil.rmtree(work, ignore_errors=True)
    return {"argv": r.args[1:], "images": len(names), "generate_s": gen_s,
            "generate_images_per_s_with_startup": GEN_IMAGES / gen_s,
            "pregen_metrics": metrics, "pregen_launches": launches,
            "cli_evalnog": {"argv": c.args[1:], "exit": c.returncode,
                            "fid": fid, "wall_s": cli_s}}


def bf16_grad_parity(tcfg32, tcfg16, seed=0):
    """One Gmain + Dmain + R1 gradient at batch 2 on the card in float32 and
    with bf16 blocks (same weights and draws, noise strengths 0, TF32 off),
    and the bf16 run again with cuDNN's autotuner on (other convolution
    algorithms, another bf16 rounding): each leaf's bf16 error against
    float32 within BF16_RATIO times the other bf16 run's error (+ 1e-3 of
    the leaf's norm; the PARITY_LOOSE leaves + 1e-2)."""
    g32, _ = parity_grads(tcfg32, "cuda", seed, strength=0.0)
    g16, s16 = parity_grads(tcfg16, "cuda", seed, strength=0.0)
    with cudnn_flags(benchmark=True):
        g16b, _ = parity_grads(tcfg16, "cuda", seed, strength=0.0)
    err = dict((k, e) for e, k in rel_errs(g16, g32))
    spread = dict((k, e) for e, k in rel_errs(g16b, g32))
    bad = []
    for k, e in err.items():
        slack = PARITY_LOOSE_TOL if is_loose(k) else PARITY_TOL
        if not e <= BF16_RATIO * spread[k] + slack:
            bad.append((k, e, spread[k]))
    worst = sorted(((e, k, spread[k]) for k, e in err.items()),
                   reverse=True)
    row = {"leaves": len(err), "worst_5": worst[:5],
           "median_rel_err": worst[len(worst) // 2][0],
           "median_other_bf16_rel_err": sorted(spread.values())[
               len(spread) // 2],
           "ratio_bound": BF16_RATIO, "failed": bad, "bf16_grad_s": s16}
    if bad:
        raise AssertionError(f"bf16 gradient leaves off: {bad[:5]}")
    return row


def stylegan2_path(build, total):
    """``stylegan2_generator_256`` as configured (bf16 above 16²) at batch 8
    with random noise, launches exact; card against CPU in float32 with
    constant noise (TF32 off); one ``unconditional_g_main_loss`` step into
    G against ``stylegan2_discriminator_256`` (bf16 below 32²), through
    the bf16 grad kernel."""
    import copy
    from shgan_torch.models.registry import get_model
    from shgan_torch.runtime.config import model_cfg_bank
    from shgan_torch.train import loss as L
    from shgan_torch.train.step import (freeze_buffers, make_optimizer,
                                        optimizer_step)
    bank = model_cfg_bank()
    cfg = bank(SG2_MODEL)
    G = get_model(cfg, seed=0)
    noise_reaches_image(G)
    G = G.cuda().eval().requires_grad_(False)
    z = torch.randn(TRAIN_BATCH, G.z_dim,
                    generator=torch.Generator().manual_seed(6)).cuda()
    want, want16 = forward_launches(G, encoder=False)

    def fwd():
        with torch.inference_mode():
            return G(z, noise_mode="random", noise_seed=77)
    fwd()
    img, launches, l16 = counted(build, fwd)
    add_launches(total, launches)
    if launches != want or l16 != want16:
        raise AssertionError(f"StyleGAN2 launches {launches} / bf16 {l16}, "
                             f"expected {want} / {want16}")
    if tuple(img.shape) != (TRAIN_BATCH, 3, 256, 256) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"StyleGAN2 image {tuple(img.shape)}")
    ms = eager_ms(fwd, 5)
    # card vs CPU, float32, constant noise
    cfg32 = copy.deepcopy(cfg)
    cfg32["args"]["synthesis"]["args"]["use_fp16_after_res"] = None
    Gc = get_model(cfg32, seed=0)
    noise_reaches_image(Gc)
    Gc.requires_grad_(False)
    z1 = z[:1].cpu()
    with torch.no_grad():
        cpu = Gc(z1, noise_mode="const")
        Gc.cuda()
        card = Gc(z1.cuda(), noise_mode="const").cpu()
    diff = float((card - cpu).abs().max())
    if not diff <= SG2_ATOL:
        raise AssertionError(f"StyleGAN2 card vs CPU: {diff}")
    del Gc
    # one generator step of the unconditional family's loss
    D = get_model(bank(SG2_D), seed=1).cuda().requires_grad_(False)
    G.train().requires_grad_(True)
    w0 = G.mapping.w_avg.clone()
    opt = make_optimizer(freeze_buffers(G))

    def step():
        loss, aux = L.unconditional_g_main_loss(
            G, D, z, None, torch.Generator().manual_seed(8))
        loss.backward()
        return loss.detach(), aux
    (loss, aux), sl, sl16 = counted(build, step)
    add_launches(total, sl)
    n_syn, layers, _ = sites_of(G.synthesis)
    n_d, c_d = sites_of(D)[0], conv_sites(D)
    b_syn, b_layers, _ = sites_of(G.synthesis, torch.bfloat16)
    b_d, bc_d = sites_of(D, torch.bfloat16)[0], conv_sites(D, torch.bfloat16)
    swant = {"upfirdn2d": n_syn + n_d, "upfirdn2d_grad": n_syn + n_d,
             "philox_normal": 0, "conv3x3_lowch": 0,
             "noise_bias_act": layers, "noise_bias_act_grad": layers + c_d,
             "bias_lrelu": c_d}
    swant16 = {"upfirdn2d": b_syn + b_d, "upfirdn2d_grad": b_syn + b_d,
               "noise_bias_act": b_layers,
               "noise_bias_act_grad": b_layers + bc_d, "bias_lrelu": bc_d}
    if sl != swant or sl16 != swant16 or not b_layers:
        raise AssertionError(f"StyleGAN2 loss launches {sl} / bf16 {sl16}, "
                             f"expected {swant} / {swant16}")
    grads = [p.grad for p in freeze_buffers(G)]
    if not math.isfinite(float(loss)) or any(
            g is None or not bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"StyleGAN2 loss {float(loss)} or a gradient "
                             "not finite")
    optimizer_step(opt, 0)
    with torch.no_grad():
        G.mapping.w_avg.copy_(aux["w_avg"])
    moved = float((G.mapping.w_avg - w0).abs().max())
    if not moved > 0:
        raise AssertionError("w_avg did not move")
    row = {"model": SG2_MODEL, "d": SG2_D, "batch": TRAIN_BATCH,
           "noise_mode": "random", "launches_per_forward": launches,
           "bf16_launches_per_forward": l16, "forward_ms": ms,
           "card_vs_cpu_max_abs": diff, "card_vs_cpu_atol": SG2_ATOL,
           "loss": float(loss), "step_launches": sl,
           "step_bf16_launches": sl16, "w_avg_moved": moved}
    del G, D, opt
    torch.cuda.empty_cache()
    return row


def bf16_path(tmp, cli, build, fir, nba, noise, inc_pth, tcfg32, fgr32,
              egr32):
    """Phase 11: the bf16 throughput configuration (blocks above 16² in
    bfloat16) on the card.  Returns (the phase's row, the bf16 rows of the
    grad kernel and of K2's backward, the phase's launches)."""
    t_phase = time.perf_counter()
    total = {}
    with bf16_tally(fir, nba), graph_tallies(bf16_launches):
        serving = bf16_serving(build, total)
        t_gen = time.perf_counter()
        gen = bf16_generate(tmp, cli, build, inc_pth)
        gen["wall_s"] = time.perf_counter() - t_gen
        # training with bf16 blocks, as a user trains (cuDNN's defaults)
        torch.backends.cudnn.allow_tf32 = True
        train_row, tcfg16 = train_path(tmp, cli, build, bf16=True)
        for st in train_row["launches_per_step"]:
            add_launches(total, st)
        torch.backends.cudnn.allow_tf32 = False
        sg2 = stylegan2_path(build, total)
    # the bf16 derivative kernels against their plain versions (TF32 off):
    # the grad kernel at the bf16 layers of shgan_g256 (32²-256²), both
    # modes; K2's backward at the training path's resampling calls
    g256 = tcfg16["model_g"]
    layers16 = {k: v for k, v in epilogue_layers(g256).items() if k[0] > 16}
    egr16 = check_epilogue_grad(noise, nba, g256, TRAIN_BATCH,
                                TRAIN_BATCH // 2, torch.bfloat16, layers16)
    calls16 = [c for c in train_fir_calls(g256, tcfg16["model_d"],
                                          TRAIN_BATCH) if 2 in c[3:5]]
    fgr16 = check_fir_grad(fir, calls16, torch.bfloat16)
    parity = bf16_grad_parity(tcfg32, tcfg16)
    same = [r for r in egr32 if r["res"] > 16]
    fsame = [r for r in fgr32 if 2 in (r["up"], r["down"])]
    row = {"phase": "bf16_path",
           "serving": serving, "generate": gen,
           "train": {k: train_row[k] for k in (
               "step_ms", "images_per_s_steps_1_5", "peak_mem_gib",
               "bf16_launches_per_step", "bf16_sites", "ticks",
               "max_weight_move")},
           "stylegan2": sg2, "grad_parity": parity,
           "grad_kernel_bf16": {
               "layers": [[r["res"], r["channels"]] for r in egr16],
               "max_abs_err": max(r["max_abs_err"] for r in egr16),
               "sums_max_rel_err": max(r["sums_max_rel_err"] for r in egr16),
               "ms": sum(r["ms"] * r["layers_per_forward"] for r in egr16),
               "float32_ms_same_layers": sum(
                   r["ms"] * r["layers_per_forward"] for r in same),
               "noise_equals_k1": True},
           "k2_backward_bf16": {
               "calls": len(fgr16),
               "max_abs_err": max(r["max_abs_err"] for r in fgr16),
               "ms": sum(r["ms"] for r in fgr16),
               "float32_ms_same_calls": sum(r["ms"] for r in fsame)},
           "launches": total, "wall_s": time.perf_counter() - t_phase}
    emit(row)
    return row, egr16, fgr16, total


# ---------------------------------------------------------------------------
# phase 12: several devices (shgan_torch.parallel)
# ---------------------------------------------------------------------------

MD_WORLD = 2
MD_BATCH = 8          # the global train batch: 2 ranks x 4, or 1 x 8
MD_STEPS = 3          # step 0 with Gpl and R1
MD_EVAL_IMAGES = 64
MD_EVAL_BATCH = 32    # the global eval batch: 2 ranks x 16, or 1 x 32
MD_ROW0 = 3
MD_ENGINE_BATCH = 8   # shgan_g512 over two devices, 4 rows each
MD_D_TOL = 1e-4       # D across ranks on N(0, 1) inputs (run 6: <= 8e-5)
MD_SPREAD = 4         # step 0's gradient: within 4x its median spread
MD_RANK_CODE = ("import sys, chip_smoke; sys.exit(chip_smoke.md_rank(int("
                "sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]))")
# The float32 spread of step 0's gradient on one card: step 0 run again
# under cuDNN's autotuner and under its deterministic algorithms, beside
# the run under its default ones; each pair of the three runs is a sample
# (default-autotuner, default-deterministic, autotuner-deterministic), and
# a gate reads their median (one sample ranged 1.1e-3-1.05e-2 of D's norm)
SPREAD_RUNS = (("spread_bench:", {"benchmark": True}),
               ("spread_det:", {"deterministic": True}))


def net_rel(x, y, keys, net):
    """``|x - y| / |y|`` over the gradient leaves ``keys`` of network
    ``net`` (their prefix, ``"G."`` or ``"D."``), in float64."""
    ks = [k for k in keys if k.startswith(net)]
    return float(np.sqrt(sum(((x[k].astype(np.float64) - y[k]) ** 2).sum()
                             for k in ks))
                 / np.sqrt(sum((y[k].astype(np.float64) ** 2).sum()
                               for k in ks)))


def spread_gate(got, ref, one, keys, prefix=""):
    """Step 0's gradients ``got`` (``prefix`` + leaf) held against
    ``ref``: per network its error, the median of its three float32 spread
    samples on one card (the runs of :data:`SPREAD_RUNS` beside the default
    one, all in ``one``) and the samples, and the networks beyond
    ``max(PARITY_TOL, MD_SPREAD * median)``.  Returns ``(nets, bad)``."""
    runs = [one] + [{k: one[p + k] for k in keys} for p, _ in SPREAD_RUNS]
    mine = {k: got[prefix + k] for k in keys}
    nets, bad = {}, []
    for net in ("G.", "D."):
        samples = [net_rel(runs[i], runs[j], keys, net)
                   for i, j in ((1, 0), (2, 0), (1, 2))]
        med = sorted(samples)[1]
        e = net_rel(mine, ref, keys, net)
        nets[net] = (e, med, samples)
        if e > max(PARITY_TOL, MD_SPREAD * med):
            bad.append((e, net, med))
    return nets, bad


def check_row_offset(noise, nba, cfg, batch, row0=MD_ROW0):
    """K1, the fused epilogue and its grad kernel (full and mask-only mode)
    at every synthesis layer shape of ``cfg`` on ``batch`` rows whose noise
    starts at counter row ``row0`` (a rank's block of a global batch):
    float32 and bf16, each element (the noise, y, dx, the mask-only output)
    equal bit for bit to rows ``row0...`` of the same launch over ``row0 +
    batch`` rows (the grad kernel's per-plane sums d dcoefs within 1e-5 of
    their terms' magnitudes of them: the kernel splits a plane's sum into
    chunks by the batch's size), and to its plain version at ``row0``
    within phase 2's and phase 8's rules (the epilogue: 4 float32 ulp or
    one bf16 ulp + the noise term; the grad kernel on K1's noise: dx 4 ulp
    / one bf16 ulp, the sums 1e-5 of their terms' magnitudes)."""
    from shgan_torch.ops.bias_act import parse_activation
    spec = cfg["args"]["synthesis"]["args"].get(
        "activation", "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")
    act = nba.epilogue_act(parse_activation(spec))
    gen = torch.Generator(device="cuda").manual_seed(77)
    n = row0 + batch
    rows, worst = [], {"epilogue": 0.0, "grad_dx": 0.0, "grad_sums": 0.0,
                       "mask": 0.0}
    for (r, c) in sorted(epilogue_layers(cfg)):
        key = noise.noise_key(99, 2 * r)
        big = noise.philox_normal_cuda(key, n, r, "cuda")
        part = noise.philox_normal_cuda(key, batch, r, "cuda", row0=row0)
        want = noise.philox_normal_plain(key, batch, r, "cuda", row0=row0)
        torch.cuda.synchronize()
        if not torch.equal(part, big[row0:]):
            raise AssertionError(f"K1 at row0 {row0}, R={r}: not the rows "
                                 "of the larger launch")
        if not float((part - want).abs().max()) <= NOISE_ATOL:
            raise AssertionError(f"K1 at row0 {row0}, R={r} vs plain")
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((n, c, r, r), generator=gen,
                            device="cuda").to(dtype)
            dy = torch.randn((n, c, r, r), generator=gen,
                             device="cuda").to(dtype)
            d = torch.rand((n, c), generator=gen, device="cuda") + 0.5
            b = torch.randn((c,), generator=gen, device="cuda") * 0.1
            s = torch.full((), 0.1, device="cuda")
            kw = dict(bias=b, act=act, noise_mode="random", noise_key=key,
                      strength=s)
            kp = dict(kw, dcoefs=d[row0:].contiguous(), row0=row0)
            xp, dyp = x[row0:].contiguous(), dy[row0:].contiguous()
            outs = {
                "y": (nba.noise_bias_act_cuda(xp, out=torch.empty_like(xp),
                                              **kp),
                      nba.noise_bias_act_cuda(x, out=torch.empty_like(x),
                                              dcoefs=d, **kw)[row0:]),
                "grad": (nba.noise_bias_act_grad_cuda(dyp, xp, **kp),
                         [t[row0:] if t.dim() else t for t in
                          nba.noise_bias_act_grad_cuda(dy, x, dcoefs=d,
                                                       **kw)]),
                "mask": (nba.noise_bias_act_mask_cuda(dyp, xp, **kp),
                         nba.noise_bias_act_mask_cuda(dy, x, dcoefs=d,
                                                      **kw)[row0:])}
            torch.cuda.synchronize()
            gp, gw = outs["grad"]
            same = {"y": torch.equal(*outs["y"]),
                    "mask": torch.equal(*outs["mask"]),
                    "dx": torch.equal(gp[0], gw[0])}
            if not all(same.values()):
                raise AssertionError(f"epilogue kernels at row0 {row0}, R={r}"
                                     f" {dtype}: not the larger launch's "
                                     f"rows: {same}")
            ulps = ((lambda v: bf16_ulp(v.float()))
                    if dtype == torch.bfloat16 else
                    (lambda v: 4 * 2.0 ** (torch.floor(torch.log2(
                        v.abs().clamp_min(1e-30))) - 23)))
            noise_tol = NOISE_ATOL * float(s) * act[1]
            y_want = nba.noise_bias_act_plain(xp.float(), **kp)
            dy_ = (outs["y"][0].float() - y_want).abs()
            if not bool((dy_ <= ulps(y_want) + noise_tol).all()):
                raise AssertionError(f"epilogue at row0 {row0} R={r} {dtype}"
                                     f": {float(dy_.max())}")
            with k1_noise_in_plain(nba, noise):
                g_want = nba.noise_bias_act_grad_plain(dyp, xp, **kp)
                m_want = nba.noise_bias_act_mask_plain(dyp, xp, **kp)
                g64 = nba.noise_bias_act_mask_plain(
                    dyp.float(), xp.float(), **kp).double()
            dxd = (gp[0].float() - g_want[0].float()).abs()
            md = (outs["mask"][0].float() - m_want.float()).abs()
            if not (bool((dxd <= ulps(g_want[0])).all())
                    and bool((md <= ulps(m_want)).all())):
                raise AssertionError(f"grad kernel at row0 {row0} R={r} "
                                     f"{dtype}: {float(dxd.max())}, "
                                     f"{float(md.max())}")
            nu = part[:, None].double()
            x64 = xp.double()
            mag_dd = (g64 * x64).abs().sum((2, 3))
            sums = max(float(((a.double() - w.double()).abs()
                              / (m + 1e-30)).max()) for a, w, m in (
                (gp[1], g_want[1], mag_dd),
                (gp[2], g_want[2], g64.abs().sum((0, 2, 3))),
                (gp[3], g_want[3], (g64 * nu).abs().sum()),
                # d dcoefs of the larger launch's rows: its plane sums split
                # into chunks by the batch's size, so in another order
                (gp[1], gw[1], mag_dd)))
            if not sums <= 1e-5:
                raise AssertionError(f"grad kernel sums at row0 {row0} R={r}"
                                     f" {dtype}: {sums}")
            for k, v in (("epilogue", float(dy_.max())),
                         ("grad_dx", float(dxd.max())), ("grad_sums", sums),
                         ("mask", float(md.max()))):
                worst[k] = max(worst[k], v)
            rows.append((r, c, str(dtype).split(".")[-1]))
            del x, dy, outs, gp, gw, g_want, m_want, g64
        torch.cuda.empty_cache()
    return {"row0": row0, "batch": batch, "shapes": rows,
            "max_abs_err": worst, "bit_for_bit_rows": True}


def md_train_config(tmp, steps, resume=None):
    """``shgan_ffhq256_train`` as phase 8 runs it (full width, float32, the
    dataset swapped to synthetic 256²), the global batch ``MD_BATCH``,
    ``steps`` steps in ticks of one, a snapshot at the end, no grids."""
    from shgan_torch.main import build_config
    nimg = steps * MD_BATCH
    return build_config(
        TRAIN_EXPERIMENT, dataset="synthetic256_inpainting",
        log_root=os.path.join(tmp, "train"), resume_path=resume,
        overrides={"train.experiment_id": 0, "train.batch_size": MD_BATCH,
                   "train.total_kimg": nimg / 1000,
                   "train.kimg_per_tick": MD_BATCH / 1000,
                   "train.snapshot_ticks": 1000,
                   "train.image_snapshot_ticks": 0,
                   "env.mesh_devices": None})


def md_eval_config(tmp, g_pth, inc_pth, data_root):
    """``shgan_ffhq256_eval`` at full-width ``shgan_g256`` (random weights
    from ``g_pth``) on the first ``MD_EVAL_IMAGES`` of an FFHQ-format zip:
    fid (random Inception), psnr, ssim and ``md_capture`` (the composites),
    random noise, the global batch ``MD_EVAL_BATCH``."""
    from shgan_torch.main import build_config
    cfg = build_config("shgan_ffhq256_eval", eval_id=0, pretrained=g_pth,
                       log_root=os.path.join(tmp, "eval"))
    ev = cfg["eval"]
    ev["dataset"]["root_dir"] = data_root
    ev.update(batch_size=MD_EVAL_BATCH, noise_mode="random",
              log_display=1000, evaluator=[
                  {"type": "fid", "args": {
                      "detector_weights": inc_pth,
                      "dsstat_cachefile_tag": "md",
                      "cache_dir": os.path.join(tmp, "cache")}},
                  {"type": "psnr", "args": {"for_dataset": None,
                                            "rgb_range": 1}},
                  {"type": "ssim", "args": {"window_size": 11}},
                  {"type": "md_capture"}])
    return cfg


def md_register_capture():
    """An evaluator that keeps the composites (uint8), gathered over the
    ranks with every other accumulator, for the uint8 comparison."""
    from shgan_torch.eval.base import (_EVALUATOR_REGISTRY, BaseEvaluator,
                                       register_evaluator)
    if "md_capture" in _EVALUATOR_REGISTRY:
        return _EVALUATOR_REGISTRY["md_capture"]

    @register_evaluator("md_capture")
    class Capture(BaseEvaluator):
        last = None

        def __init__(self):
            super().__init__()
            self.data_fake = []

        def add_batch(self, fake=None, valid=None, **_):
            (fake,) = self._apply_valid([np.asarray(fake)], valid)
            self.data_fake.append(np.rint(fake).astype(np.uint8))

        def compute(self):
            Capture.last = np.concatenate(self.data_fake)
            self.final = {"images": int(len(Capture.last))}
            return self.final["images"]
    return Capture


def md_d_check(device):
    """``comodgan_d256`` (weights from seed 1, TF32 off) on a global batch
    of ``MD_BATCH`` N(0, 1) inputs: the logits, R1's input gradient, and
    the weight gradients of a Dmain-like loss (two D calls) and of R1's
    penalty, averaged over the ranks; this rank's rows of each batch.
    Inputs far apart keep the minibatch stddev well conditioned, so the
    ranks' values agree with one process's to float32 rounding."""
    from shgan_torch.models.registry import get_model
    from shgan_torch.parallel import create_mesh
    from shgan_torch.parallel.multihost import world_size
    mesh = create_mesh(device=device) if world_size() > 1 else None
    D = get_model(model_cfg_bank_cfg(TRAIN_D), seed=1).to(device)
    g = np.random.RandomState(3)
    res = int(model_cfg_bank_cfg(TRAIN_D)["args"]["resolution"])
    xs = [torch.from_numpy(g.randn(MD_BATCH, 4, res, res).astype(np.float32))
          for _ in range(2)]
    rows = None
    if mesh is not None:
        rows = mesh.rows(MD_BATCH)
        xs = [rows.take(x) for x in xs]
    xf, xr = (x.to(device) for x in xs)
    out = {}
    lf = D(xf, rows=rows)
    lr = D(xr, rows=rows)
    (F.softplus(lf).mean() + F.softplus(-lr).mean()).backward()
    grads = [p.grad.clone() for p in D.parameters()]
    D.zero_grad(set_to_none=True)
    xr = xr.clone().requires_grad_(True)
    r1, = torch.autograd.grad(D(xr, rows=rows).sum(), xr, create_graph=True)
    (r1.square().sum((1, 2, 3)).mean() * 5.0).backward()
    for (name, p), gm in zip(D.named_parameters(), grads):
        for tag, t in (("main", gm), ("r1", p.grad if p.grad is not None
                                      else torch.zeros_like(p))):
            if mesh is not None:
                mesh.all_reduce_mean_(t)
            out[f"dchk_{tag}.{name}"] = t.detach().cpu().numpy()
    out["dchk_logits"] = lf.detach().cpu().numpy()
    out["dchk_r1"] = r1.detach().cpu().numpy()
    del D
    torch.cuda.empty_cache()
    return out


def md_work(tmp, device, inc_pth, data_root, g_pth, spread=False):
    """One rank's (or the one process's) share of phase 12: the train
    stage for ``MD_STEPS`` steps with the step-0 gradients (the averaged
    ones, as the optimizers read them), ``w_avg`` and ``pl_mean`` after
    each step, the launches of each step, the replicas checked after each
    step, the noise rows each kernel launch started at and the snapshot
    writes; a resume for one more step; with ``spread``, step 0 once more
    under each of :data:`SPREAD_RUNS` (other algorithms: the float32
    spread on one device); :func:`md_d_check`; then the eval stage
    over ``MD_EVAL_IMAGES`` with its launches and the composites.  Returns
    the record and writes the arrays to ``<tmp>/md_<rank>.npz``."""
    from shgan_torch import main as cli
    from shgan_torch.kernels import build
    from shgan_torch.ops import noise_bias_act as nba
    from shgan_torch.parallel import check_replicated
    from shgan_torch.parallel.multihost import rank, world_size
    from shgan_torch.runtime import stages
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    r, w = rank(), world_size()
    rec = {"rank": r, "world": w, "device": str(device)}
    arrays = {}
    held = {}
    row0s, saves = set(), [0]

    class Recording(stages.TrainStep):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            held["step"] = self
            for opt, net in ((self.opt_g, "G"), (self.opt_d, "D")):
                names = {id(p): n for n, p in
                         (self.G if net == "G" else self.D).named_parameters()}
                inner = opt.step

                def step(*a, opt=opt, net=net, names=names, inner=inner):
                    if self.step == 0:
                        pre = held.get("prefix", "")
                        for g in opt.param_groups:
                            for p in g["params"]:
                                arrays[f"{pre}{net}.{names[id(p)]}"] = \
                                    p.grad.detach().cpu().numpy()
                    return inner(*a)
                opt.step = step

    def track(fn):
        def wrapped(*a, row0=0, **k):
            row0s.add(int(row0))
            return fn(*a, row0=row0, **k)
        return wrapped

    def counting(fn):
        def wrapped(*a, **k):
            saves[0] += 1
            return fn(*a, **k)
        return wrapped

    per_step, wavg, plm = [], [], []

    def start(step_i):
        torch.cuda.synchronize()
        build.reset_launches()

    def done(step_i, metrics):
        torch.cuda.synchronize()
        st = held["step"]
        G, D = st.G, st.D
        got = dict(build.launches)
        want = expected_train_launches(*train_sites(G, D),
                                       step_i % st.cfg.g_reg_interval == 0,
                                       step_i % st.cfg.d_reg_interval == 0)
        if got != want:
            raise AssertionError(f"rank {r} step {step_i}: launches {got}, "
                                 f"expected {want}")
        per_step.append(got)
        check_replicated([G, D, st.G_ema, st.pl_mean])   # bit for bit
        wavg.append(G.mapping.w_avg.detach().cpu().numpy())
        plm.append(float(st.pl_mean))

    orig = (stages.TrainStep, nba.noise_bias_act_cuda, nba._grad_launch,
            stages.save_train_state)
    stages.TrainStep = Recording
    nba.noise_bias_act_cuda = track(orig[1])
    nba._grad_launch = track(orig[2])
    stages.save_train_state = counting(orig[3])
    try:
        t0 = time.perf_counter()
        tcfg = md_train_config(tmp, MD_STEPS)
        rv = cli.run(tcfg, device=device, on_step_start=start, on_step=done)
        rec["train_s"] = time.perf_counter() - t0
        rec["step_ms"] = [1e3 * s for s in rv["timing"]["step_s"]]
        snap = os.path.join(tcfg["train"]["log_dir"], "weight",
                            "network-snapshot-000000")
        t0 = time.perf_counter()
        rv2 = cli.run(md_train_config(tmp, MD_STEPS + 1, resume=snap),
                      device=device, on_step_start=start, on_step=done)
        rec["resume_s"] = time.perf_counter() - t0
        if rv2["step"].step != MD_STEPS + 1:
            raise AssertionError(f"resumed to step {rv2['step'].step}")
        for prefix, flags in SPREAD_RUNS if spread else ():
            held["prefix"] = prefix
            with cudnn_flags(**flags):
                cli.run(md_train_config(os.path.join(tmp, prefix[:-1]), 1),
                        device=device)
    finally:
        (stages.TrainStep, nba.noise_bias_act_cuda, nba._grad_launch,
         stages.save_train_state) = orig
    rec.update(launches_per_step=per_step, row0s=sorted(row0s),
               snapshot_writes=saves[0], pl_mean=plm,
               train_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    arrays["w_avg"] = np.stack(wavg)
    arrays.update(md_d_check(device))

    # eval: the composites, the metrics and the launches
    Capture = md_register_capture()
    from shgan_torch.eval.base import ComposeEvaluator
    from shgan_torch.models.registry import get_model
    from shgan_torch.runtime.config import model_cfg_bank
    writes = [0]
    save = ComposeEvaluator.save

    def saving(self, log_dir):
        writes[0] += 1
        return save(self, log_dir)
    ComposeEvaluator.save = saving
    try:
        cfg = md_eval_config(tmp, g_pth, inc_pth, data_root)
        torch.backends.cudnn.allow_tf32 = True   # as a user evaluates
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        erv = cli.run(cfg, device=device)
        torch.cuda.synchronize()
        rec["eval_s"] = time.perf_counter() - t0
        launches = dict(build.launches)
    finally:
        ComposeEvaluator.save = save
    per_fwd, _ = forward_launches(get_model(model_cfg_bank()(FULL_G)))
    batches = MD_EVAL_IMAGES // MD_EVAL_BATCH
    want = {k: v * batches for k, v in per_fwd.items()}
    if launches != want:
        raise AssertionError(f"rank {r} eval launches {launches}, expected "
                             f"{want}")
    t = erv["timing"]
    rec.update(eval_launches=launches, result_writes=writes[0],
               eval_rv={k: erv["eval_rv"][k] for k in ("fid", "psnr",
                                                      "ssim")},
               eval_images_per_s=MD_EVAL_IMAGES / (sum(t["batch_s"])
                                                   + t["drain_s"]),
               eval_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    arrays["composites"] = Capture.last
    np.savez(os.path.join(tmp, f"md_{r}.npz"), **arrays)
    with open(os.path.join(tmp, f"md_{r}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def md_rank(rank, world, port, tmp, device, inc_pth, data_root, g_pth):
    """A rank process of phase 12 (``python -c``): join the group through
    ``SHGAN_DIST_*`` on ``device``, then :func:`md_work`."""
    t_start = time.time()
    os.environ.update(SHGAN_DIST_COORDINATOR=f"127.0.0.1:{port}",
                      SHGAN_DIST_NPROCS=str(world), SHGAN_DIST_PID=str(rank))
    from shgan_torch.kernels import build
    from shgan_torch.parallel import maybe_initialize_distributed
    maybe_initialize_distributed(device=device)
    build.build_all()
    with open(os.path.join(tmp, f"md_up_{rank}.json"), "w") as f:
        json.dump({"joined": time.time(), "start": t_start}, f)
    md_work(tmp, device, inc_pth, data_root, g_pth)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def md_spawn(tmp, inc_pth, data_root, g_pth):
    """Two rank processes (``python -c`` importing the port): both on
    ``cuda:0`` over gloo on a one-card machine, on ``cuda:0`` and
    ``cuda:1`` over NCCL where there are two.  A rank that fails makes
    this raise (the other is stopped).  Returns (records, start-up
    seconds)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    two = torch.cuda.device_count() >= 2
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SHGAN_DIST_", "MASTER_", "WORLD_SIZE"))}
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MD_RANK_CODE, str(r), str(MD_WORLD),
         str(port), tmp, f"cuda:{r if two else 0}", inc_pth, data_root,
         g_pth],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MD_WORLD)]
    logs = [[] for _ in procs]
    import threading
    readers = [threading.Thread(target=lambda p=p, log=log: log.extend(
        p.stdout), daemon=True) for p, log in zip(procs, logs)]
    for t in readers:
        t.start()
    try:
        deadline = time.time() + 900
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                raise AssertionError("phase 12's ranks did not finish")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join(timeout=10)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode})\n" + "".join(log)[-4000:]
            for r, (p, log) in enumerate(zip(procs, logs))))
    recs, up = [], []
    for r in range(MD_WORLD):
        with open(os.path.join(tmp, f"md_{r}.json")) as f:
            recs.append(json.load(f))
        with open(os.path.join(tmp, f"md_up_{r}.json")) as f:
            up.append(json.load(f)["joined"] - t0)
    return recs, up, "nccl" if two else "gloo"


def md_nccl_alone():
    """One NCCL rank (world 1) through the port's own path: the group
    joined, the device collectives on NCCL by rule, its all-reduce
    returning its input."""
    import socket
    import torch.distributed as dist
    from shgan_torch.parallel import create_mesh, maybe_initialize_distributed
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    keys = ("SHGAN_DIST_COORDINATOR", "SHGAN_DIST_NPROCS", "SHGAN_DIST_PID")
    os.environ.update(zip(keys, (f"127.0.0.1:{port}", "1", "0")))
    try:
        t0 = time.perf_counter()
        maybe_initialize_distributed(device="cuda:0")
        mesh = create_mesh()
        if mesh.backend != "nccl":
            raise AssertionError(f"one rank on its own card: {mesh.backend}")
        x = torch.arange(1024, device="cuda", dtype=torch.float32) * 0.5
        y = mesh.all_reduce_(x.clone())
        torch.cuda.synchronize()
        if not torch.equal(x, y):
            raise AssertionError("NCCL all-reduce of one rank changed it")
        init_s = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in keys:
            os.environ.pop(k, None)
    return {"backend": "nccl", "world": 1, "all_reduce_equal": True,
            "init_s": init_s}


def md_engine(build):
    """The engine over ``["cuda:0", "cuda:0"]`` at ``shgan_g512`` batch 8,
    random noise, against the one-device engine on the same weights:
    phase 4's uint8 rule, known pixels exact, launches of two forwards of
    4 rows a request."""
    from shgan_torch.serve import InpaintEngine
    res = 512
    reqs = requests(res, seed=5)
    outs, ms, launches = {}, {}, {}
    torch.backends.cudnn.allow_tf32 = False
    for name, mesh in (("one", None), ("two", ["cuda:0", "cuda:0"])):
        e = InpaintEngine(MODEL, batch_size=MD_ENGINE_BATCH, device="cuda",
                          mesh=mesh, noise_mode="random", seed=0)
        noise_reaches_image(e.G)
        for G in e.replicas.values():
            G.load_state_dict(e.G.state_dict())
        imgs, masks = reqs[0]
        e.inpaint(imgs, masks)       # first use
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        outs[name] = e.inpaint(imgs, masks, start_index=16)
        ms[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = dict(build.launches)
        e.close()
        del e
        torch.cuda.empty_cache()
    per_fwd = len(fir_calls(model_cfg_bank_cfg(MODEL), MD_ENGINE_BATCH))
    if launches["two"]["upfirdn2d"] != 2 * per_fwd or any(
            launches["two"][k] != 2 * launches["one"][k]
            for k in ("noise_bias_act", "bias_lrelu")):
        raise AssertionError(f"engine launches {launches}")
    d = np.abs(outs["two"].astype(np.int16) - outs["one"].astype(np.int16))
    within1 = float((d <= 1).mean())
    imgs, masks = reqs[0]
    keep = np.broadcast_to(masks[:, None] > 0.5, imgs.shape)
    if not np.array_equal(outs["two"][keep], quantized(imgs)[keep]):
        raise AssertionError("engine over two devices: known pixels differ")
    if within1 < 0.999 or d.max() > 2:
        raise AssertionError(f"engine over two devices vs one: {within1} "
                             f"within 1, max {int(d.max())}")
    return {"model": MODEL, "batch": MD_ENGINE_BATCH,
            "mesh": ["cuda:0", "cuda:0"], "noise_mode": "random",
            "within_1": within1, "max_abs_diff": int(d.max()),
            "known_pixels_exact": True, "request_ms": ms,
            "launches": launches}


def model_cfg_bank_cfg(name):
    from shgan_torch.runtime.config import model_cfg_bank
    return model_cfg_bank()(name)


def multi_device_path(tmp, build, noise, nba, inc_pth):
    """Phase 12: the kernels at a row offset; the train and eval stages on
    two ranks against one process; one NCCL rank; the engine over two
    devices."""
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "multi_device")
    os.makedirs(work)
    offset = check_row_offset(noise, nba, model_cfg_bank_cfg(FULL_G),
                              MD_BATCH // MD_WORLD)
    emit({"phase": "kernel_check", "kernel": "row_offset", **offset})
    data_root, _ = ffhq_zip(work, MD_EVAL_IMAGES, FULL_RES, seed=3)
    g_pth = os.path.join(work, f"{FULL_G}_random.pth")
    random_weights(FULL_G, g_pth)
    one_dir, two_dir = os.path.join(work, "one"), os.path.join(work, "two")
    os.makedirs(one_dir)
    os.makedirs(two_dir)
    one = md_work(one_dir, "cuda", inc_pth, data_root, g_pth, spread=True)
    two, up_s, backend = md_spawn(two_dir, inc_pth, data_root, g_pth)
    a = dict(np.load(os.path.join(one_dir, "md_0.npz")))
    b = dict(np.load(os.path.join(two_dir, "md_0.npz")))
    b1 = dict(np.load(os.path.join(two_dir, "md_1.npz")))
    T = lambda arr, keys: {k: torch.from_numpy(arr[k]) for k in keys}  # noqa
    # D on inputs far apart: the ranks' D to float32 rounding (1e-4)
    dkeys = [k for k in a if k.startswith("dchk_") and k[5:8] in ("mai",
                                                                    "r1.")]
    d_rel = rel_errs(T(b, dkeys), T(a, dkeys))
    lg = np.concatenate([b["dchk_logits"], b1["dchk_logits"]])
    r1 = np.concatenate([b["dchk_r1"], b1["dchk_r1"]])
    d_in = max(float(np.abs(lg - a["dchk_logits"]).max()
                     / np.abs(a["dchk_logits"]).max()),
               float(np.abs(r1 - a["dchk_r1"]).max()
                     / np.abs(a["dchk_r1"]).max()))
    if not (d_rel[0][0] <= MD_D_TOL and d_in <= MD_D_TOL):
        raise AssertionError(f"D across ranks: {d_rel[:4]}, logits and R1's "
                             f"input gradient {d_in}")
    # step 0's gradients (Gmain + Gpl + Dmain + R1; the penalties are
    # second order, and their float32 spread on one card, cuDNN's
    # algorithms changed, reaches 1e-3-1e-2 a leaf: a leaky ReLU that
    # switches slope moves a penalty's gradient): each network within
    # phase 8's 1e-3 or MD_SPREAD times the median of its spread samples
    grads = [k for k in a if k[:2] in ("G.", "D.")]
    rel = rel_errs(T(b, grads), T(a, grads))
    bench = SPREAD_RUNS[0][0]
    spread = dict((k[len(bench):], e) for e, k in rel_errs(
        T(a, [bench + k for k in grads]),
        {bench + k: torch.from_numpy(a[k]) for k in grads}))
    nets, bad = spread_gate(b, a, a, grads)
    for k in grads + ["w_avg"]:
        if not np.array_equal(b[k], b1[k]):
            raise AssertionError(f"ranks differ in {k}")
    w_rel = float(np.abs(b["w_avg"] - a["w_avg"]).max()
                  / np.abs(a["w_avg"]).max())
    pl_rel = max(abs(x - y) / abs(y) for x, y in zip(two[0]["pl_mean"],
                                                    one["pl_mean"]))
    if bad or w_rel > PARITY_TOL or pl_rel > PARITY_TOL:
        raise AssertionError(f"2 ranks vs 1: {bad[:8]}, w_avg {w_rel}, "
                             f"pl_mean {pl_rel}")
    if not (two[0]["snapshot_writes"] >= 1 and two[1]["snapshot_writes"] == 0
            and two[0]["result_writes"] == 1 and two[1]["result_writes"] == 0):
        writes = [(t["snapshot_writes"], t["result_writes"]) for t in two]
        raise AssertionError(f"writes (snapshots, result.json) by rank: "
                             f"{writes}")
    if not (set(two[1]["row0s"]) - {0} and two[0]["row0s"] == [0]):
        raise AssertionError(f"noise rows: {two[0]['row0s']}, "
                             f"{two[1]['row0s']}")
    # eval: fid within 1e-3, the composites by phase 4's rule
    fid1, fid2 = one["eval_rv"]["fid"], two[0]["eval_rv"]["fid"]
    d = np.abs(b["composites"].astype(np.int16)
               - a["composites"].astype(np.int16))
    within1 = float((d <= 1).mean())
    if not (abs(fid2 - fid1) <= 1e-3 * abs(fid1) and within1 >= 0.999
            and d.max() <= 2 and b["composites"].shape[0] == MD_EVAL_IMAGES):
        raise AssertionError(f"eval 2 ranks vs 1: fid {fid2} vs {fid1}, "
                             f"{within1} within 1, max {int(d.max())}")
    nccl = md_nccl_alone()
    engine = md_engine(build)
    row = {"phase": "multi_device_path", "ranks": MD_WORLD,
           "backend": backend, "train": {
               "experiment": TRAIN_EXPERIMENT, "global_batch": MD_BATCH,
               "steps": MD_STEPS, "grad_leaves": len(rel),
               "step0_grad_net_rel_median_spread_samples": nets,
               "step0_grad_worst_rel": rel[0],
               "step0_grad_worst_spread": spread[rel[0][1]],
               "step0_grad_median_rel": rel[len(rel) // 2][0],
               "step0_grad_median_spread": sorted(spread.values())[
                   len(spread) // 2],
               "d_check_worst_rel": d_rel[0], "d_check_logits_r1_rel": d_in,
               "w_avg_rel": w_rel, "pl_mean_rel": pl_rel,
               "replicas_bit_identical": True,
               "step_ms_one": one["step_ms"],
               "step_ms_ranks": [t["step_ms"] for t in two],
               "launches_per_step_rank": two[0]["launches_per_step"],
               "row0s_rank1": two[1]["row0s"],
               "snapshot_writes": [t["snapshot_writes"] for t in two],
               "resumed_on_both": True},
           "eval": {"experiment": "shgan_ffhq256_eval", "model": FULL_G,
                    "images": MD_EVAL_IMAGES, "global_batch": MD_EVAL_BATCH,
                    "one": one["eval_rv"], "ranks": two[0]["eval_rv"],
                    "composites_within_1": within1,
                    "composites_max_diff": int(d.max()),
                    "result_writes": [t["result_writes"] for t in two],
                    "images_per_s_one": one["eval_images_per_s"],
                    "images_per_s_ranks": [t["eval_images_per_s"]
                                           for t in two],
                    "launches_rank": two[0]["eval_launches"]},
           "startup_s": up_s,
           "peak_gib_one": [one["train_peak_gib"], one["eval_peak_gib"]],
           "peak_gib_ranks": [[t["train_peak_gib"], t["eval_peak_gib"]]
                              for t in two],
           "nccl_alone": nccl, "engine": engine,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    total = {}
    for t in [one] + two:
        for s in t["launches_per_step"]:
            add_launches(total, s)
        add_launches(total, t["eval_launches"])
    add_launches(total, engine["launches"]["two"])
    return row, offset, total


# ---------------------------------------------------------------------------
# phase 13: spatial (H) sharding (shgan_torch.parallel.spatial)
# ---------------------------------------------------------------------------

SP_MODEL = 2             # the model axis: two rank processes on cuda:0
SP_FWD_MIN_RES = 512     # shgan_g1024: the 512² and 1024² levels on slabs
SP_FWD_BATCH = 4
SP_TRAIN_MIN_RES = 64    # shgan_g256: the 64²-256² levels on slabs
SP_STEPS = 3             # step 0 with Gpl and R1
SP_KERNEL_BATCH = 2       # the sweep of every shgan_g1024 layer at m = 2, 4
SP_K3_TOL = 1e-4
SP_RANK_CODE = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.sp_rank(*sys.argv[1:]))")


def slab_windows(res, m):
    """The rows ``(h0, h1)`` of each of ``m`` ranks' slabs of a plane."""
    r = res // m
    return [(i * r, (i + 1) * r) for i in range(m)]


def check_slab_kernels(noise, nba, conv1024, cfg, batch, models,
                       min_res=8, pl_batch=None):
    """The kernels' slab and window modes at ``batch`` on every synthesis
    layer shape of ``cfg`` at or above ``min_res`` (and above 4²), for each
    model axis of ``models``: K1 alone, the fused epilogue and its grad
    kernel (full, and mask-only at ``batch`` and at ``pl_batch``, the
    path-length penalty's rows) on each rank's window of plane rows,
    float32 and bf16 (the const noise in float32 too), each element equal
    bit for bit to those rows of the whole-plane launch, the windows' sums
    within 1e-5 of their terms' magnitudes of the whole plane's; each
    window of ``models[0]`` against the plain versions by phase 2's and
    phase 8's rules.  Returns the record."""
    from shgan_torch.ops.bias_act import parse_activation
    spec = cfg["args"]["synthesis"]["args"].get(
        "activation", "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")
    act = nba.epilogue_act(parse_activation(spec))
    gen = torch.Generator(device="cuda").manual_seed(78)
    n = batch
    worst = {"k1_plain": 0.0, "epilogue_plain": 0.0, "grad_plain": 0.0,
             "window_sums": 0.0}
    shapes = []
    for (r, c) in sorted(epilogue_layers(cfg)):
        if r <= 4 or r < min_res:
            continue
        key = noise.noise_key(98, 2 * r)
        k1 = noise.philox_normal_cuda(key, n, r, "cuda", row0=1)
        for m in models:
            for h0, h1 in slab_windows(r, m):
                part = noise.philox_normal_cuda(key, n, r, "cuda", row0=1,
                                                h0=h0, rows=h1 - h0)
                if not torch.equal(part, k1[:, h0:h1]):
                    raise AssertionError(f"K1 window {h0}:{h1} of {r}²")
                if m == models[0]:
                    want = noise.philox_normal_plain(key, n, r, "cuda", 1,
                                                     h0, h1 - h0)
                    worst["k1_plain"] = max(worst["k1_plain"], float(
                        (part - want).abs().max()))
        if worst["k1_plain"] > NOISE_ATOL:
            raise AssertionError(f"K1 window vs plain: {worst}")
        for dtype, modes in ((torch.float32, ("random", "const")),
                             (torch.bfloat16, ("random",))):
            for mode in modes:
                x = torch.randn((n, c, r, r), generator=gen,
                                device="cuda").to(dtype)
                dy = torch.randn((n, c, r, r), generator=gen,
                                 device="cuda").to(dtype)
                d = torch.rand((n, c), generator=gen, device="cuda") + 0.5
                b = torch.randn((c,), generator=gen, device="cuda") * 0.1
                s = torch.full((), 0.1, device="cuda")
                const = torch.randn((r, r), generator=gen, device="cuda")
                kw = dict(dcoefs=d, bias=b, act=act, noise_mode=mode,
                          noise_key=key, strength=s, row0=1)
                y = nba.noise_bias_act_cuda(x, out=torch.empty_like(x),
                                            noise_const=const, **kw)
                gw = nba.noise_bias_act_grad_cuda(dy, x, noise_const=const,
                                                  **kw)
                mw = nba.noise_bias_act_mask_cuda(dy, x, noise_const=const,
                                                  **kw)
                kpl = dict(kw, dcoefs=d[:pl_batch].contiguous())
                if pl_batch:
                    mw_pl = nba.noise_bias_act_mask_cuda(
                        dy[:pl_batch].contiguous(), x[:pl_batch].contiguous(),
                        noise_const=const, **kpl)
                g64 = gw[0].double() / d.double()[:, :, None, None]
                nu = (k1[:, None] if mode == "random" else const).double()
                mags = ((g64 * x.double()).abs().sum((2, 3)),
                        g64.abs().sum((0, 2, 3)), (g64 * nu).abs().sum())
                for m in models:
                    sums = [torch.zeros_like(t, dtype=torch.float64)
                            for t in gw[1:]]
                    for h0, h1 in slab_windows(r, m):
                        kp = dict(kw, noise_const=const[h0:h1], h0=h0)
                        xs = x[:, :, h0:h1].contiguous()
                        dys = dy[:, :, h0:h1].contiguous()
                        ys = nba.noise_bias_act_cuda(
                            xs, out=torch.empty_like(xs), **kp)
                        gs = nba.noise_bias_act_grad_cuda(dys, xs, **kp)
                        ms_ = nba.noise_bias_act_mask_cuda(dys, xs, **kp)
                        same = {"y": torch.equal(ys, y[:, :, h0:h1]),
                                "dx": torch.equal(gs[0], gw[0][:, :, h0:h1]),
                                "mask": torch.equal(ms_, mw[:, :, h0:h1])}
                        if pl_batch:
                            kq = dict(kp, dcoefs=kpl["dcoefs"])
                            xq = xs[:pl_batch].contiguous()
                            dq = dys[:pl_batch].contiguous()
                            mq = nba.noise_bias_act_mask_cuda(dq, xq, **kq)
                            same["mask_pl"] = torch.equal(
                                mq, mw_pl[:, :, h0:h1])
                        if not all(same.values()):
                            raise AssertionError(
                                f"epilogue kernels on rows {h0}:{h1} of "
                                f"{r}² at batch {n} ({dtype}, {mode}): "
                                f"{same}")
                        sums = [a + t.double() for a, t in zip(sums, gs[1:])]
                        if m == models[0]:
                            plain_checks(nba, noise, xs, dys, kp, ys, gs,
                                         ms_, act, s, dtype, worst)
                            if pl_batch:
                                plain_checks(nba, noise, xq, dq, kq, None,
                                             None, mq, act, s, dtype, worst)
                    err = max(float(((a - w.double()).abs()
                                     / (mg + 1e-30)).max())
                              for a, w, mg in zip(sums, gw[1:], mags))
                    worst["window_sums"] = max(worst["window_sums"], err)
                    if err > 1e-5:
                        raise AssertionError(f"grad kernel window sums at "
                                             f"{r}², m={m}: {err}")
                shapes.append((r, c, str(dtype).split(".")[-1], mode))
                del x, dy, y, gw, mw, g64, nu
            torch.cuda.empty_cache()
    return {"layers": shapes, "batch": n, "pl_batch": pl_batch,
            "models": list(models), "bit_for_bit_windows": True,
            "max_err": worst}


def plain_checks(nba, noise, xs, dys, kp, ys, gs, ms_, act, s, dtype, worst):
    """A window's launches against their plain versions: the epilogue
    (``ys``) within 4 float32 ulp (one bf16 ulp) + the noise term; the grad
    kernel (``gs``) on K1's noise, dx within 4 ulp (one bf16 ulp) and the
    sums within 1e-5 of their terms' magnitudes (phase 8's rules); the
    mask-only output (``ms_``) within 4 ulp (one bf16 ulp).  ``ys`` / ``gs``
    None: that launch is not checked."""
    ulps = ((lambda v: bf16_ulp(v.float())) if dtype == torch.bfloat16 else
            (lambda v: 4 * 2.0 ** (torch.floor(torch.log2(
                v.abs().clamp_min(1e-30))) - 23)))
    bad = []
    if ys is not None:
        noise_tol = NOISE_ATOL * float(s) * act[1]
        y_want = nba.noise_bias_act_plain(xs.float(), **kp)
        dyy = (ys.float() - y_want).abs()
        if not bool((dyy <= ulps(y_want) + noise_tol).all()):
            bad.append(("y", float(dyy.max())))
        worst["epilogue_plain"] = max(worst["epilogue_plain"],
                                      float(dyy.max()))
    with k1_noise_in_plain(nba, noise):
        m_want = nba.noise_bias_act_mask_plain(dys, xs, **kp)
        g_want = (nba.noise_bias_act_grad_plain(dys, xs, **kp)
                  if gs is not None else None)
    md = (ms_.float() - m_want.float()).abs()
    if not bool((md <= ulps(m_want)).all()):
        bad.append(("mask", float(md.max())))
    worst["grad_plain"] = max(worst["grad_plain"], float(md.max()))
    if gs is not None:
        dxd = (gs[0].float() - g_want[0].float()).abs()
        if not bool((dxd <= ulps(g_want[0])).all()):
            bad.append(("dx", float(dxd.max())))
        worst["grad_plain"] = max(worst["grad_plain"], float(dxd.max()))
        nu = nba._noise_plain(dys, kp["noise_mode"], kp["noise_key"],
                              kp["noise_const"], kp["row0"], kp["h0"])
        g = m_want.double()
        x64 = xs.double()
        for a, w_, mag in ((gs[1], g_want[1], (g * x64).abs().sum((2, 3))),
                           (gs[2], g_want[2], g.abs().sum((0, 2, 3))),
                           (gs[3], g_want[3], (g * nu.double()).abs().sum())):
            rel = float(((a.double() - w_.double()).abs()
                         / (mag + 1e-30)).max())
            worst["grad_sums_plain"] = max(worst.get("grad_sums_plain", 0.0),
                                           rel)
            if rel > 1e-5:
                bad.append(("sums", rel))
    if bad:
        raise AssertionError(f"window vs plain ({dtype}, {tuple(xs.shape)}):"
                             f" {bad}")


def check_slab_k3(conv1024, batch):
    """K3's halo'd slab mode on the slabs of [batch, 32, 1024²] (m = 2 and
    4), float32 and bf16, against those rows of the whole-plane launch and
    against its plain version on each slab of m = 2 (phase 2's rules)."""
    gen = torch.Generator(device="cuda").manual_seed(79)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((batch, 32, 1024, 1024), generator=gen,
                        device="cuda").to(dtype)
        w = torch.randn((32, 32, 3, 3), generator=gen,
                        device="cuda") / math.sqrt(9 * 32)
        with torch.inference_mode():
            whole = conv1024.conv3x3_lowch(x, w)
            xp = F.pad(x, (0, 0, 1, 1))
            rows_err = plain_err = 0.0
            for m in (2, 4):
                for h0, h1 in slab_windows(1024, m):
                    xs = xp[:, :, h0:h1 + 2].contiguous()
                    ys = conv1024.conv3x3_lowch(xs, w, halo=1)
                    rows_err = max(rows_err, float(
                        (ys.float() - whole[:, :, h0:h1].float()).abs().max()))
                    if m == 2:
                        want = conv1024.conv3x3_lowch_plain(xs, w, halo=1)
                        err = (ys.float() - want.float()).abs()
                        tol = (bf16_ulp(want.float()) + 1e-6
                               if dtype == torch.bfloat16 else SP_K3_TOL)
                        if not bool((err <= tol).all()):
                            raise AssertionError(f"K3 slab vs plain "
                                                 f"{dtype}: {float(err.max())}")
                        plain_err = max(plain_err, float(err.max()))
        torch.cuda.synchronize()
        if rows_err > SP_K3_TOL:
            raise AssertionError(f"K3 slabs vs the whole plane {dtype}: "
                                 f"{rows_err}")
        out[str(dtype).split(".")[-1]] = {"vs_whole_plane": rows_err,
                                          "vs_plain": plain_err,
                                          "batch": batch}
        del x, whole, xp
        torch.cuda.empty_cache()
    return out


def fir_route_of(x, up, down):
    """The route ``fir_route`` (upfirdn2d.cuh) gives a K2 launch."""
    if x.data_ptr() % 16:
        return "generic"
    return {((1, 1), (1, 1)): "tile", ((1, 1), (2, 2)): "down2",
            ((2, 2), (1, 1)): "up2"}.get((tuple(up), tuple(down)), "generic")


def sp_forward(mesh):
    """``shgan_g1024`` at batch 4 through the engine, random weights and
    noise, K3 on, TF32 off; under ``spatial_sharding(mesh, 512)`` on a rank
    (``mesh`` None: the one process).  Returns (the record, the
    composites)."""
    from contextlib import nullcontext
    from shgan_torch.kernels import build
    from shgan_torch.parallel import spatial
    from shgan_torch.serve import InpaintEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e = InpaintEngine(MODEL_1024, batch_size=SP_FWD_BATCH, device="cuda",
                      noise_mode="random", seed=0)
    noise_reaches_image(e.G)
    for G in e.replicas.values():
        G.load_state_dict(e.G.state_dict())
    rng = np.random.RandomState(21)
    imgs = rng.randint(0, 256, (SP_FWD_BATCH, 3, 1024, 1024), dtype=np.uint8)
    masks = (rng.rand(SP_FWD_BATCH, 1024, 1024) > 0.5).astype(np.float32)
    routes = {"tile": 0, "down2": 0, "up2": 0, "generic": 0}
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
    orig = fir.fir_cuda

    def tally(x, taps, up=(1, 1), down=(1, 1), pads=(0, 0, 0, 0),
              counter="upfirdn2d"):
        routes[fir_route_of(x, up, down)] += 1
        return orig(x, taps, up, down, pads, counter)

    ctx = (spatial.spatial_sharding(mesh, SP_FWD_MIN_RES) if mesh is not None
           else nullcontext())
    # the one process's engine replays a graph (the ranks' runs eagerly):
    # its routes are the capture's, once a replay
    with ctx, graph_tallies(routes):
        fir.fir_cuda = tally
        try:
            e.inpaint(imgs, masks)                 # first use
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            routes.update(dict.fromkeys(routes, 0))
            if mesh is not None:
                mesh.traffic.update(halo_bytes=0, sum_bytes=0)
            t0 = time.perf_counter()
            out = e.inpaint(imgs, masks, start_index=8)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            path = e.path()
        finally:
            fir.fir_cuda = orig
    rec = {"request_ms": ms, "launches": dict(build.launches),
           "k2_routes": routes, "path": path,
           "traffic_bytes": dict(mesh.traffic) if mesh is not None else {},
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    keep = np.broadcast_to(masks[:, None] > 0.5, imgs.shape)
    rec["known_pixels_exact"] = bool(np.array_equal(out[keep],
                                                    quantized(imgs)[keep]))
    e.close()
    del e
    torch.cuda.empty_cache()
    return rec, out


def sp_train(mesh, spread=False, remat=False):
    """``shgan_ffhq256_train``'s networks (``shgan_g256`` +
    ``comodgan_d256``, random weights, noise on), its loss settings, the
    global batch 8 of synthetic 256² images: ``SP_STEPS`` steps of
    ``TrainStep`` (step 0 with Gpl and R1), under ``spatial_sharding(mesh,
    64)`` on a rank (``mesh`` None: the one process), TF32 off; step 0's
    gradients (as the optimizers read them), launches and ms of each step,
    the replicas checked after each; with ``spread``, step 0 once more
    under each of :data:`SPREAD_RUNS` (the float32 spread); with
    ``remat``, step 0 once more with the networks of ``train.remat``
    (arrays ``remat:``, launches by the recompute rule).  Returns (record,
    arrays)."""
    from contextlib import nullcontext
    from shgan_torch.data.rng import derive_seed
    from shgan_torch.kernels import build
    from shgan_torch.models.registry import get_model
    from shgan_torch.parallel import check_replicated, spatial
    from shgan_torch.runtime.stages import remat_configs, step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config(tempfile.mkdtemp(prefix="sp_cfg_"), SP_STEPS)
    tc = TrainConfig(**(cfg["train"].get("loss_kwargs") or {}))
    rng = np.random.RandomState(31)
    real = torch.from_numpy(rng.uniform(-1, 1, (TRAIN_BATCH, 3, 256, 256))
                            .astype(np.float32)).cuda()
    mask = torch.from_numpy((rng.rand(TRAIN_BATCH, 1, 256, 256) > 0.5)
                            .astype(np.float32)).cuda()
    ctx = (lambda: spatial.spatial_sharding(mesh, SP_TRAIN_MIN_RES)
           if mesh is not None else nullcontext())
    arrays = {}

    def run(prefix, steps, remat=False):
        cfg_g, cfg_d = cfg["model_g"], cfg["model_d"]
        if remat:
            cfg_g, cfg_d = remat_configs(cfg_g, cfg_d)
        G = get_model(cfg_g, seed=0)
        noise_reaches_image(G)
        D = get_model(cfg_d, seed=derive_seed(0, 1))
        G, D = G.cuda(), D.cuda()
        step = TrainStep(G, D, tc, mesh=mesh)
        for opt, net in ((step.opt_g, "G"), (step.opt_d, "D")):
            names = {id(p): k for k, p in
                     (G if net == "G" else D).named_parameters()}
            inner = opt.step

            def rec_step(*a, opt=opt, net=net, names=names, inner=inner):
                if step.step == 0:
                    for g in opt.param_groups:
                        for p in g["params"]:
                            arrays[f"{prefix}{net}.{names[id(p)]}"] = \
                                p.grad.detach().cpu().numpy()
                return inner(*a)
            opt.step = rec_step
        redo = train_sites(G, D, remat=True)
        per_step, ms = [], []
        for i in range(steps):
            greg, dreg = i % tc.g_reg_interval == 0, i % tc.d_reg_interval == 0
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            with ctx():
                step(real, mask, step_generator(0, i), 0.99, do_greg=greg,
                     do_dreg=dreg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got = dict(build.launches)
            want = expected_train_launches(*train_sites(G, D), greg, dreg,
                                           recompute=redo)
            if got != want:
                raise AssertionError(f"step {i} ({'rank' if mesh else 'one'}"
                                     f"{', remat' if remat else ''}): "
                                     f"launches {got}, expected {want}")
            per_step.append(got)
            if mesh is not None:
                check_replicated([G, D, step.G_ema, step.pl_mean], mesh=mesh)
        return per_step, ms

    torch.cuda.reset_peak_memory_stats()
    per_step, ms = run("", SP_STEPS)
    rec = {"launches_per_step": per_step, "step_ms": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    for prefix, flags in SPREAD_RUNS if spread else ():
        with cudnn_flags(**flags):
            run(prefix, 1)
    if remat:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches, ms = run("remat:", 1, remat=True)
        rec.update(remat_launches=launches[0], remat_step_ms=ms[0],
                   remat_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    torch.cuda.empty_cache()
    return rec, arrays


def sp_rank(rank, world, port, tmp, cards=1):
    """A rank process of :func:`sp_sharded_vs_one` (``python -c``): join
    the group on ``cuda:0`` (``cards`` 1: two ranks share the card, over
    gloo) or on card ``rank`` (one card a rank, NCCL), a mesh with a model
    axis of ``world``; the forward and the training of :func:`sp_forward`
    / :func:`sp_train` under ``spatial_sharding``; records and arrays into
    ``tmp``."""
    rank, world, cards = int(rank), int(world), int(cards)
    import faulthandler
    # a rank that hangs prints where, before sp_spawn's deadline kills it
    faulthandler.dump_traceback_later(540, exit=True)
    os.environ.update(SHGAN_DIST_COORDINATOR=f"127.0.0.1:{port}",
                      SHGAN_DIST_NPROCS=str(world), SHGAN_DIST_PID=str(rank))
    from shgan_torch.kernels import build
    from shgan_torch.parallel import create_mesh, maybe_initialize_distributed
    maybe_initialize_distributed(device=f"cuda:{rank if cards > 1 else 0}")
    build.build_all()
    mesh = create_mesh(model=world)
    fwd, comp = sp_forward(mesh)
    train, arrays = sp_train(mesh, remat=True)
    np.savez(os.path.join(tmp, f"sp_{rank}.npz"), composites=comp, **arrays)
    with open(os.path.join(tmp, f"sp_{rank}.json"), "w") as f:
        json.dump({"forward": fwd, "train": train, "device": str(mesh.device),
                   "transport": mesh.transport, "backend": mesh.backend,
                   "replica_gap": mesh.replica_gap}, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sp_spawn(tmp, world, cards):
    """``world`` rank processes of :func:`sp_rank`, on ``cards`` cards. A
    rank that fails makes this raise."""
    import socket
    import threading
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SHGAN_DIST_", "MASTER_", "WORLD_SIZE"))}
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SP_RANK_CODE, str(r), str(world), str(port),
         tmp, str(cards)], cwd=os.path.dirname(os.path.abspath(__file__)),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [[] for _ in procs]
    readers = [threading.Thread(target=lambda p=p, log=log: log.extend(
        p.stdout), daemon=True) for p, log in zip(procs, logs)]
    for t in readers:
        t.start()
    late = False
    try:
        deadline = time.time() + 600
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                late = True
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join(timeout=10)
    if late or any(p.returncode != 0 for p in procs):
        raise AssertionError(
            ("the ranks did not finish" if late else "a rank failed")
            + ":\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode})\n" + "".join(log)[-4000:]
            for r, (p, log) in enumerate(zip(procs, logs))))
    recs = []
    for r in range(world):
        with open(os.path.join(tmp, f"sp_{r}.json")) as f:
            recs.append(json.load(f))
    return recs, time.time() - t0


def sp_sharded_vs_one(work, world, cards):
    """``shgan_g1024``'s forward and ``shgan_ffhq256_train``'s steps in
    this process on ``cuda:0``, then on ``world`` model ranks spread over
    ``cards`` cards (:func:`sp_spawn`), each rank held against the one
    process: the forward's uint8 composites by phase 4's rule with the
    known pixels exact and the ranks' composites equal, each rank's
    launches (K3, K2 by route, the epilogue) the one process's, halo rows
    exchanged; step 0's gradients each network within 1e-3 or
    ``MD_SPREAD`` times the median of its float32 spread samples on one
    card measured here (:func:`spread_gate`, phase 12's rule), equal on
    every rank, the replicas checked bit for bit after every step on the
    ranks, launches the one process's every step; the ranks' step 0 with
    ``train.remat``'s networks held to their step 0 without it by the same
    gate, equal on every rank, its launches by the recompute rule.
    Returns (the record, the launches of every run)."""
    one_fwd, one_comp = sp_forward(None)
    one_train, one_arr = sp_train(None, spread=True)
    torch.cuda.empty_cache()
    ranks, spawn_s = sp_spawn(work, world, cards)
    a = [dict(np.load(os.path.join(work, f"sp_{r}.npz")))
         for r in range(world)]
    fwd = [t["forward"] for t in ranks]
    d = np.abs(a[0]["composites"].astype(np.int16)
               - one_comp.astype(np.int16))
    within1 = float((d <= 1).mean())
    if not all(np.array_equal(a[0]["composites"], x["composites"])
               for x in a[1:]):
        raise AssertionError("the ranks' composites differ")
    if within1 < 0.999 or d.max() > 2 or not all(
            f["known_pixels_exact"] for f in fwd + [one_fwd]):
        raise AssertionError(f"sharded shgan_g1024 vs one process: {within1}"
                             f" within 1, max {int(d.max())}")
    for f in fwd:
        if (f["launches"] != one_fwd["launches"]
                or f["k2_routes"] != one_fwd["k2_routes"]
                or f["k2_routes"]["generic"]
                or f["launches"]["conv3x3_lowch"] != 2):
            raise AssertionError(f"forward launches on a rank {f['launches']}"
                                 f" {f['k2_routes']}, one process "
                                 f"{one_fwd['launches']} "
                                 f"{one_fwd['k2_routes']}")
        if not f["traffic_bytes"]["halo_bytes"] > 0:
            raise AssertionError("no halo was exchanged")
    grads = [k for k in one_arr if k[:2] in ("G.", "D.")]
    for k in grads:
        if not all(np.array_equal(a[0][k], x[k]) for x in a[1:]):
            raise AssertionError(f"the ranks' gradients differ in {k}")

    nets, bad = spread_gate(a[0], one_arr, one_arr, grads)
    emit({"phase": "spatial_step0_gate", "nets": nets})
    if bad:
        raise AssertionError(
            f"sharded step 0 vs one process: {bad} (every network's error, "
            f"median spread and samples {nets}; the forward held: {within1} "
            f"within 1, {one_fwd['request_ms']} ms one process, "
            f"{[f['request_ms'] for f in fwd]} ms the ranks)")
    # the ranks' remat step 0 against their step 0 without remat
    for k in grads:
        if not all(np.array_equal(a[0]["remat:" + k], x["remat:" + k])
                   for x in a[1:]):
            raise AssertionError(f"the ranks' remat gradients differ in {k}")
    remat_nets, remat_bad = spread_gate(a[0], a[0], one_arr, grads,
                                        "remat:")
    remat_bit = all(np.array_equal(a[0]["remat:" + k], a[0][k])
                    for k in grads)
    if remat_bad:
        raise AssertionError(f"sharded remat step 0 vs sharded step 0: "
                             f"{remat_bad} ({remat_nets})")
    for t in ranks:
        if t["train"]["launches_per_step"] != one_train["launches_per_step"]:
            raise AssertionError("a rank's train launches differ from one "
                                 "process's")
    row = {"model_axis": world, "cards": cards,
           "devices": [t["device"] for t in ranks],
           "backend": ranks[0]["backend"], "transport": ranks[0]["transport"],
           "forward": {"model": MODEL_1024, "batch": SP_FWD_BATCH,
                       "min_res": SP_FWD_MIN_RES, "noise": "random",
                       "k3": True, "composites_within_1": within1,
                       "composites_max_diff": int(d.max()),
                       "known_pixels_exact": True,
                       "launches_rank": fwd[0]["launches"],
                       "k2_routes_rank": fwd[0]["k2_routes"],
                       "bytes_exchanged_per_rank": [f["traffic_bytes"]
                                                    for f in fwd],
                       "request_ms_one": one_fwd["request_ms"],
                       "request_ms_ranks": [f["request_ms"] for f in fwd],
                       "peak_gib_one": one_fwd["peak_gib"],
                       "peak_gib_ranks": [f["peak_gib"] for f in fwd]},
           "train": {"experiment": TRAIN_EXPERIMENT,
                     "global_batch": TRAIN_BATCH, "steps": SP_STEPS,
                     "min_res": SP_TRAIN_MIN_RES,
                     "step0_grad_net_rel_median_spread_samples": nets,
                     "remat_step0_vs_step0": remat_nets,
                     "remat_step0_bit_identical": remat_bit,
                     "remat_launches_rank": ranks[0]["train"][
                         "remat_launches"],
                     "remat_step_ms_ranks": [t["train"]["remat_step_ms"]
                                             for t in ranks],
                     "remat_peak_gib_ranks": [t["train"]["remat_peak_gib"]
                                              for t in ranks],
                     "replicas_bit_identical": True,
                     "model_ranks_grad_gap": [t["replica_gap"]
                                              for t in ranks],
                     "launches_per_step_rank":
                         ranks[0]["train"]["launches_per_step"],
                     "step_ms_one": one_train["step_ms"],
                     "step_ms_ranks": [t["train"]["step_ms"] for t in ranks],
                     "peak_gib_one": one_train["peak_gib"],
                     "peak_gib_ranks": [t["train"]["peak_gib"]
                                        for t in ranks]},
           "ranks_wall_s": spawn_s}
    total = {}
    for f in fwd + [one_fwd]:
        add_launches(total, f["launches"])
    for t in [one_train] + [r["train"] for r in ranks]:
        for s in t["launches_per_step"]:
            add_launches(total, s)
    for r in ranks:
        add_launches(total, r["train"]["remat_launches"])
    return row, total


def spatial_path(tmp, noise, nba, conv1024):
    """Phase 13: the kernels' slab and window modes; ``shgan_g1024``'s
    forward and ``shgan_ffhq256_train``'s steps on two model ranks of one
    card against one process."""
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "spatial")
    os.makedirs(work)
    # every layer at m = 2 and 4, then the shapes phase 13's own path gives
    # the kernels: the sharded levels of the shgan_g1024 forward at its
    # batch, and shgan_g256's at the train batch (the grad kernel's full
    # mode there, its mask-only mode at the path-length rows too)
    g1024 = model_cfg_bank_cfg(MODEL_1024)
    kernels = {
        "sweep": check_slab_kernels(noise, nba, conv1024, g1024,
                                    SP_KERNEL_BATCH, (2, 4)),
        "forward": check_slab_kernels(noise, nba, conv1024, g1024,
                                      SP_FWD_BATCH, (SP_MODEL,),
                                      SP_FWD_MIN_RES),
        "train": check_slab_kernels(noise, nba, conv1024,
                                    model_cfg_bank_cfg(TRAIN_G), TRAIN_BATCH,
                                    (SP_MODEL,), SP_TRAIN_MIN_RES,
                                    TRAIN_BATCH // 2),
        "k3": check_slab_k3(conv1024, SP_FWD_BATCH)}
    emit({"phase": "kernel_check", "kernel": "slab_windows", **kernels})
    row, total = sp_sharded_vs_one(work, SP_MODEL, 1)
    row = {"phase": "spatial_path", **row,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    return row, kernels, total


# ---------------------------------------------------------------------------
# phase 14: per-block rematerialization (train.remat, models/remat.py)
# ---------------------------------------------------------------------------

REMAT_EXACT_BATCH = 8    # both modes bit for bit, launches by the rule
REMAT_MEMORY_BATCH = 32  # peak memory and step ms of each mode
# the modes at the memory batch, in this order every run (each mode's
# first use of the batch's shapes falls on its first run)
REMAT_ORDER = (False, True, True, False)


def remat_path(tmp):
    """Phase 14: ``shgan_ffhq256_train``'s networks (``shgan_g256`` +
    ``comodgan_d256``, random weights, noise on) with and without
    ``train.remat`` (the models of ``runtime.stages.remat_configs``, the
    same weights), TF32 off, cuDNN deterministic, autotuner off, on
    synthetic 256² images; each run a ``TrainStep`` of step 0 (Gpl and
    R1) and step 1 (main only), each fenced.  At batch 8: off then on,
    every gradient as the optimizers read it, the metrics, ``pl_mean``,
    ``w_avg`` and the weights bit for bit, the launches of each step exact
    by :func:`expected_train_launches` (the recompute terms from the
    modules).  At batch 32: the modes in :data:`REMAT_ORDER`, each step's
    ms and its peak allocated and reserved memory (the cache
    emptied and the peaks reset before each step), counted above what was
    allocated and reserved when the phase began (tensors that earlier
    phases left alive; recorded beside).  Returns (the record, the launches
    of every step)."""
    import copy
    from shgan_torch.data.rng import derive_seed
    from shgan_torch.kernels import build
    from shgan_torch.models.registry import get_model
    from shgan_torch.runtime.stages import remat_configs, step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config(os.path.join(tmp, "remat"), 2)
    tc = TrainConfig(**(cfg["train"].get("loss_kwargs") or {}))
    nets = {}
    for remat in (False, True):
        cfg_g, cfg_d = cfg["model_g"], cfg["model_d"]
        if remat:
            cfg_g, cfg_d = remat_configs(cfg_g, cfg_d)
        G = get_model(cfg_g, seed=0)
        noise_reaches_image(G)
        nets[remat] = (G, get_model(cfg_d, seed=derive_seed(0, 1)))
    if cfg["model_g"]["args"]["encoder"].get("args", {}).get("remat"):
        raise AssertionError("remat_configs changed the caller's config")
    for a, b in zip(nets[False], nets[True]):
        sa, sb = a.state_dict(), b.state_dict()
        if not all(torch.equal(sa[k], sb[k]) for k in sa):
            raise AssertionError("the remat models' weights differ")
    G, D = nets[True]
    if not (G.encoder.remat and G.synthesis.remat and D.remat):
        raise AssertionError("remat_configs did not turn remat on")
    res = G.synthesis.resolution
    rng = np.random.RandomState(41)
    real = torch.from_numpy(rng.uniform(
        -1, 1, (REMAT_MEMORY_BATCH, 3, res, res)).astype(np.float32)).cuda()
    mask = torch.from_numpy((rng.rand(REMAT_MEMORY_BATCH, 1, res, res)
                             > 0.5).astype(np.float32)).cuda()
    total = {}

    def run(remat, batch, keep=False):
        G, D = (copy.deepcopy(m).cuda() for m in nets[remat])
        step = TrainStep(G, D, tc)
        grads = {}
        if keep:
            for opt, net in ((step.opt_g, "G"), (step.opt_d, "D")):
                names = {id(p): k for k, p in
                         (G if net == "G" else D).named_parameters()}
                inner = opt.step

                def rec_step(*a, opt=opt, net=net, names=names,
                             inner=inner):
                    for g in opt.param_groups:
                        for p in g["params"]:
                            grads[f"{step.step}:{net}.{names[id(p)]}"] = \
                                p.grad.detach().clone()
                    return inner(*a)
                opt.step = rec_step
        sites, redo = train_sites(G, D), train_sites(G, D, remat=True)
        rows, metrics = [], []
        for i, (greg, dreg) in enumerate(((True, True), (False, False))):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t0 = time.perf_counter()
            m = step(real[:batch], mask[:batch], step_generator(0, i), 0.99,
                     do_greg=greg, do_dreg=dreg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = dict(build.launches)
            want = expected_train_launches(*sites, greg, dreg,
                                           recompute=redo)
            if got != want:
                raise AssertionError(
                    f"remat {remat} batch {batch} step {i}: launches {got},"
                    f" expected {want}")
            add_launches(total, got)
            metrics.append(m)
            rows.append({
                "regs": "GD" if greg else "", "step_ms": ms,
                "peak_allocated_gib":
                    (torch.cuda.max_memory_allocated() - start[0]) / 2 ** 30,
                "peak_reserved_gib":
                    (torch.cuda.max_memory_reserved() - start[1]) / 2 ** 30,
                "launches": got})
        out = (rows, grads, metrics, step) if keep else (rows,)
        del G, D, step
        return out

    with cudnn_flags(deterministic=True):
        off = run(False, REMAT_EXACT_BATCH, keep=True)
        on = run(True, REMAT_EXACT_BATCH, keep=True)
        if set(off[1]) != set(on[1]) or len(off[1]) < 100:
            raise AssertionError("the remat step's gradient leaves differ")
        apart = [k for k in off[1] if not torch.equal(off[1][k], on[1][k])]
        for a, b in zip(off[2], on[2]):
            apart += [k for k in a if not torch.equal(a[k], b[k])]
        sa, sb = off[3], on[3]
        apart += [k for k in ("pl_mean",)
                  if not torch.equal(sa.pl_mean, sb.pl_mean)]
        for x, y, net in ((sa.G, sb.G, "G"), (sa.D, sb.D, "D"),
                          (sa.G_ema, sb.G_ema, "G_ema")):
            px, py = x.state_dict(), y.state_dict()
            apart += [f"{net}.{k}" for k in px
                      if not torch.equal(px[k], py[k])]
        if apart:
            raise AssertionError(f"remat against no remat at batch "
                                 f"{REMAT_EXACT_BATCH}: {len(apart)} "
                                 f"tensors differ, {apart[:6]}")
        exact = {"batch": REMAT_EXACT_BATCH, "gradients": len(off[1]),
                 "bit_identical": True, "off": off[0], "on": on[0]}
        del off, on, sa, sb
        memory = [{"remat": remat, "batch": REMAT_MEMORY_BATCH,
                   "steps": run(remat, REMAT_MEMORY_BATCH)[0]}
                  for remat in REMAT_ORDER]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        prev
    torch.cuda.empty_cache()

    def mean(remat, i, key):
        vals = [m["steps"][i][key] for m in memory if m["remat"] == remat]
        return sum(vals) / len(vals)
    summary = {
        f"{'on' if remat else 'off'}_{name}": {
            k: mean(remat, i, k) for k in ("step_ms", "peak_allocated_gib",
                                           "peak_reserved_gib")}
        for remat in (False, True) for i, name in ((0, "reg"), (1, "main"))}
    row = {"phase": "remat_path", "experiment": TRAIN_EXPERIMENT,
           "model_g": cfg["model_g"].get("name"),
           "model_d": cfg["model_d"].get("name"),
           "tf32": False, "cudnn_deterministic": True,
           "phase_start_allocated_gib": start[0] / 2 ** 30,
           "phase_start_reserved_gib": start[1] / 2 ** 30,
           "exact": exact, "memory": memory, "mean": summary,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    return row, total


# ---------------------------------------------------------------------------
# phase 15: the compiled forward (runtime/compiled.py) against the eager one
# ---------------------------------------------------------------------------

COMPILED_STARTS = (0, 8, 16, 1000, 123_456)   # five requests of 8 rows
COMPILED_STREAM = 4                           # batches through the stream


def eager_request(e, imgs, masks, start, memory_format=CL):
    """An engine's request run eagerly: its chunks padded to their buckets,
    z and the batch noise seed of each chunk's start, ``composite_forward``
    on the device, as the engine ran every batch before its forward was
    compiled; by default in the compiled forward's layout (channels-last),
    ``torch.contiguous_format`` for the eager paths' NCHW."""
    from shgan_torch.data.rng import derive_seed
    from shgan_torch.models.infer import composite_forward, z_for_positions
    from shgan_torch.serve import BATCH_NOISE_SALT, _as_model_input
    real, mask = _as_model_input(imgs, masks)
    n, bs, outs = real.shape[0], e.batch_size, []
    for lo in range(0, n, bs):
        r, m = real[lo:lo + bs], mask[lo:lo + bs]
        k = r.shape[0]
        tgt = next((b for b in e.buckets if b >= k), bs)
        if k < tgt:
            pad = [(0, tgt - k)] + [(0, 0)] * 3
            r, m = np.pad(r, pad), np.pad(m, pad, constant_values=1)
        z = z_for_positions(e.seed, e.G.z_dim, range(start + lo,
                                                     start + lo + tgt))
        with torch.inference_mode():
            out = composite_forward(
                e.G, torch.from_numpy(r).cuda(), torch.from_numpy(m).cuda(),
                torch.from_numpy(z).cuda(), noise_mode=e.noise_mode,
                noise_seed=derive_seed(e.seed, start + lo, BATCH_NOISE_SALT),
                memory_format=memory_format)
        outs.append(out[:k].cpu().numpy())
    return np.concatenate(outs)


def uint8_gap(a, b):
    """(bit for bit, share within 1, max |a - b|) of two uint8 arrays."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return bool(not d.any()), float((d <= 1).mean()), int(d.max())


def nhwc_rule(build, launches, share, what):
    """The NHWC launches since the counts were last reset
    (``kernels/build.launches_nhwc``), checked: ``share`` 1.0, every
    hand-written forward launch of a compiled replay on its NHWC map; 0.0,
    none (an eager NCHW path).  Returns them."""
    nhwc = build.snapshot_nhwc()
    got = (build.nhwc_share(launches, nhwc) if launches is not None
           else float(bool(any(nhwc.values()))))
    if got != share:
        raise AssertionError(f"{what}: NHWC launches {nhwc} of {launches}, "
                             f"a share of {got}, expected {share}")
    return nhwc


def cell_gap(got, want, masks, limits, what):
    """A composite against another within a serving cell's limits (PERF.md
    §2): known pixels equal; (% of hole values > 1 level off, their RMS gap
    in levels) at most ``limits``.  Returns the two figures."""
    kept = np.broadcast_to(masks[:, None] > 0.5, got.shape)
    if not np.array_equal(got[kept], want[kept]):
        raise AssertionError(f"{what}: known pixels differ")
    gap = got[~kept].astype(np.float64) - want[~kept].astype(np.float64)
    off = 100.0 * float((np.abs(gap) > 1).mean()) if gap.size else 0.0
    rms = float(np.sqrt((gap ** 2).mean())) if gap.size else 0.0
    if off > limits[0] or rms > limits[1]:
        raise AssertionError(f"{what}: {off:.4f} % of hole values > 1 level "
                             f"off, RMS {rms:.4f}, limits {limits}")
    return off, rms


def phase4_rule(gap, what):
    """Bit for bit, or phase 4's rule: >= 99.9 % of values within 1, max
    <= 2."""
    equal, within1, dmax = gap
    if not equal and (within1 < 0.999 or dmax > 2):
        raise AssertionError(f"{what}: compiled vs eager {within1:.6f} "
                             f"within 1, max {dmax}")


def compiled_serving(build, bf16, smi):
    """``shgan_g512`` at batch 8 (a latency bucket of 4), random noise,
    float32 or bf16: five requests at other starts, a 3-row request
    through bucket 4 and ``inpaint_stream`` at ``window=2``, each against
    the eager forward on the same inputs; launches exact per forward over
    the replays (the 3-row graph captured inside the count); request ms,
    steady images/s, the host's enqueue ms, capture seconds and pool
    GiB."""
    from shgan_torch.data.rng import derive_seed
    from shgan_torch.models.infer import composite_forward, z_for_positions
    from shgan_torch.serve import BATCH_NOISE_SALT, InpaintEngine
    e = InpaintEngine(MODEL, device="cuda", batch_size=SERVE_BATCH,
                      latency_batches=(4,), noise_mode="random", seed=0,
                      bf16=bf16)
    noise_reaches_image(e.G)
    if e.path() != "compiled":
        raise AssertionError(f"one-device engine: {e.path()}")
    res = e.G.img_resolution
    reqs = requests(res, seed=7)
    imgs8, masks8 = reqs[0]
    imgs3, masks3 = reqs[2]
    want, _ = forward_launches(e.G)
    # bucket 8 captured here; bucket 4 inside the counted requests
    e.inpaint(imgs8, masks8, start_index=77)
    torch.cuda.synchronize()
    build.reset_launches()
    outs = [e.inpaint(imgs8, masks8, start_index=st)
            for st in COMPILED_STARTS]
    out3 = e.inpaint(imgs3, masks3, start_index=40)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    modconv = build.snapshot_modconv()
    n_fwd = len(COMPILED_STARTS) + 1
    if launches != {k: v * n_fwd for k, v in want.items()}:
        raise AssertionError(f"compiled {MODEL} launches {launches}, "
                             f"expected {n_fwd} x {want}")
    want_mod = synthesis_modconv(e.G.synthesis)
    if modconv != {k: v * n_fwd for k, v in want_mod.items()}:
        raise AssertionError(f"compiled {MODEL} modulated convs {modconv}, "
                             f"expected {n_fwd} x {want_mod}")
    gaps = [uint8_gap(o, eager_request(e, imgs8, masks8, st))
            for o, st in zip(outs, COMPILED_STARTS)]
    gaps.append(uint8_gap(out3, eager_request(e, imgs3, masks3, 40)))
    for g, st in zip(gaps, list(COMPILED_STARTS) + [40]):
        phase4_rule(g, f"{MODEL} bf16={bf16} start {st}")
    # the channels-last graph against the NCHW eager forward: cuDNN may
    # pick other algorithms for the other layout, so the cell's limits
    nchw = None
    if not bf16:
        nchw = [cell_gap(o, eager_request(e, i, m, st,
                                          torch.contiguous_format),
                         m, CELL_LIMITS[MODEL], f"{MODEL} NHWC graph vs "
                         f"NCHW eager, start {st}")
                for o, (i, m), st in zip(
                    outs + [out3], [reqs[0]] * len(outs) + [reqs[2]],
                    list(COMPILED_STARTS) + [40])]
    for (imgs, masks), out in ((reqs[0], outs[0]), (reqs[2], out3)):
        keep = np.broadcast_to(masks[:, None] > 0.5, out.shape)
        if out.shape != imgs.shape or not np.array_equal(
                out[keep], quantized(imgs)[keep]):
            raise AssertionError("compiled: known pixels differ")
    if any(np.array_equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("compiled: two starts give the same images")
    # the stream keeps two replays queued: each output a copy made before
    # the next replay overwrote the graph's
    batches = [(imgs8, masks8)] * COMPILED_STREAM
    streamed = list(e.inpaint_stream(iter(batches), start_index=500,
                                     window=2))
    for i, got in enumerate(streamed):
        single = e.inpaint(imgs8, masks8, start_index=500 + 8 * i)
        if not np.array_equal(got, single):
            raise AssertionError(f"stream batch {i} differs from inpaint")
        phase4_rule(uint8_gap(got, eager_request(e, imgs8, masks8,
                                                 500 + 8 * i)),
                    f"stream batch {i}")

    # times: request ms at 8 and 3 rows, steady images/s, enqueue ms
    def req_ms(fn, imgs, masks):
        ms = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(imgs, masks, 8 * i)
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    compiled_fn = lambda i, m, st: e.inpaint(i, m, start_index=st)  # noqa
    eager_fn = lambda i, m, st: eager_request(e, i, m, st)  # noqa
    times = {}
    for name, fn in (("compiled", compiled_fn), ("eager", eager_fn),
                     ("eager", eager_fn), ("compiled", compiled_fn)):
        t = times.setdefault(name, {"ms_8": [], "ms_3": [], "ips": []})
        t["ms_8"] += req_ms(fn, imgs8, masks8)
        t["ms_3"] += req_ms(fn, imgs3, masks3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(5):
            fn(imgs8, masks8, 8 * i)
        torch.cuda.synchronize()
        t["ips"].append(5 * SERVE_BATCH / (time.perf_counter() - t0))
    # the host's enqueue: one batch's forward call, device inputs, the
    # device idle before it
    r = torch.from_numpy(imgs8).cuda()
    m = torch.from_numpy(masks8[:, None]).cuda()
    z = z_for_positions(0, e.G.z_dim, range(8))
    zd = torch.from_numpy(z).cuda()
    enq = {"compiled": [], "eager": []}
    for i in range(5):
        for name in ("compiled", "eager"):
            torch.cuda.synchronize()
            seed = derive_seed(0, 8 * i, BATCH_NOISE_SALT)
            t0 = time.perf_counter()
            if name == "compiled":
                e.compiled(r, m, z, seed)
            else:
                with torch.inference_mode():
                    composite_forward(e.G, r, m, zd, noise_seed=seed)
            enq[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    row = {"model": MODEL, "batch": SERVE_BATCH, "bf16": bf16,
           "buckets": e.buckets, "noise_mode": "random", "path": e.path(),
           "starts": list(COMPILED_STARTS), "cudnn_tf32": True,
           "bit_for_bit": [g[0] for g in gaps],
           "within_1": [g[1] for g in gaps],
           "max_abs_diff": [g[2] for g in gaps],
           "vs_nchw_eager": None if nchw is None else {
               "hole_px_off_pct": [g[0] for g in nchw],
               "hole_rms_levels": [g[1] for g in nchw],
               "limits": CELL_LIMITS[MODEL]},
           "stream_window": 2, "stream_batches": COMPILED_STREAM,
           "launches": launches, "forwards": n_fwd,
           "modconv_per_replay": {k: v / n_fwd for k, v in modconv.items()},
           "request_ms": times, "enqueue_ms": enq,
           "steady_images_per_s": {k: v["ips"] for k, v in times.items()},
           "captures": e.compiled.records,
           "pool_gib": e.compiled.pool_bytes() / 2 ** 30,
           "nvidia_smi": smi}
    e.close()
    del e
    torch.cuda.empty_cache()
    return row


def compiled_eval(tmp, cli, build, g_pth, inc_pth, smi):
    """``shgan_g1024`` at batch 4 with K3 through the eval stage over
    ``EVAL_IMAGES`` images, its forward compiled and then eager (the
    stage's own eager branch, which several ranks take, chosen by giving
    ``eager_reason`` a reason): composites by phase 4's rule, fid / psnr /
    ssim equal, launches exact; images/s of both.  The composites are kept
    on the card until the end (no readback inside the timed loop)."""
    from shgan_torch.runtime import stages
    Compiled, reason, forward = (stages.CompiledForward, stages.eager_reason,
                                 stages.composite_forward)
    got = {"compiled": [], "eager": []}
    made = []

    class Recording(Compiled):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def __call__(self, *a, **k):
            out = super().__call__(*a, **k)
            got["compiled"].append(out)
            return out

    def eager_forward(*a, **k):
        # in the compiled forward's layout: graph against eager, not layout
        # against layout (tests/test_torch_cuda.py holds the layouts apart)
        out = forward(*a, memory_format=torch.channels_last, **k)
        got["eager"].append(out)
        return out

    patches = {"compiled": {"CompiledForward": Recording},
               "eager": {"eager_reason": lambda *a, **k: "compared",
                         "composite_forward": eager_forward}}
    n_batches = EVAL_IMAGES // EVAL_BATCH
    # float32 throughout: no level casts
    want_mod = modconv_counts(int(np.log2(K3_RES)) - 1)
    calls = fir_calls(model_cfg_bank_cfg(MODEL_1024), EVAL_BATCH)
    layers = noise_layers(model_cfg_bank_cfg(MODEL_1024))
    convs = encoder_conv_layers(model_cfg_bank_cfg(MODEL_1024))
    want = {"conv3x3_lowch": 2 * n_batches,
            "upfirdn2d": len(calls) * n_batches, "upfirdn2d_grad": 0,
            "philox_normal": 0, "noise_bias_act": sum(layers.values())
            * n_batches, "noise_bias_act_grad": 0,
            "bias_lrelu": sum(convs.values()) * n_batches}
    runs = {}
    for name in ("compiled", "eager"):
        for k, v in patches[name].items():
            setattr(stages, k, v)
        try:
            cfg = eval_config(tmp, g_pth, inc_pth, EVAL_IMAGES,
                              f"log_{name}")
            build.reset_launches()
            t0 = time.perf_counter()
            rv = cli.run(cfg)
            stage_s = time.perf_counter() - t0
            launches = dict(build.launches)
            modconv = build.snapshot_modconv()
        finally:
            (stages.CompiledForward, stages.eager_reason,
             stages.composite_forward) = Compiled, reason, forward
        if launches != want:
            raise AssertionError(f"{name} eval launches {launches}, "
                                 f"expected {want}")
        if modconv != {k: v * n_batches for k, v in want_mod.items()}:
            raise AssertionError(f"{name} eval modulated convs {modconv}, "
                                 f"expected {n_batches} x {want_mod}")
        with open(os.path.join(cfg["eval"]["log_dir"], "result.json")) as f:
            result = json.load(f)
        t = rv["timing"]
        runs[name] = {
            "metrics": {k: result[k][k] for k in ("fid", "psnr", "ssim")},
            "images_per_s": EVAL_BATCH * (n_batches - 1)
            / (sum(t["batch_s"][1:]) + t["drain_s"]),
            "batch0_s": t["batch_s"][0], "stage_s": stage_s,
            "launches": launches,
            "modconv_per_forward": {k: v / n_batches
                                    for k, v in modconv.items()}}
    if len(made) != 1 or not made[0].records or len(got["eager"]) != len(
            got["compiled"]):
        raise AssertionError("the eval stage's compiled run did not capture "
                             "its forward, or its eager run did not run "
                             "eagerly")
    gap = uint8_gap(torch.cat(got["compiled"]).cpu().numpy(),
                    torch.cat(got["eager"]).cpu().numpy())
    got.clear()
    phase4_rule(gap, f"{MODEL_1024} eval")
    if runs["compiled"]["metrics"] != runs["eager"]["metrics"]:
        raise AssertionError(f"eval metrics compiled {runs['compiled']} "
                             f"vs eager {runs['eager']}")
    return {"model": MODEL_1024, "batch": EVAL_BATCH,
            "images": EVAL_IMAGES, "k3": True,
            "noise_mode": "random", "cudnn_tf32": True,
            "bit_for_bit": gap[0], "within_1": gap[1],
            "max_abs_diff": gap[2], "runs": runs,
            "captures": made[0].records, "nvidia_smi": smi}


def compiled_path(tmp, cli, build, g_pth, inc_pth, smi):
    """Phase 15: the compiled forward against the eager one, at
    ``shgan_g512`` b8 (float32 and bf16) through the engine and at
    ``shgan_g1024`` b4 with K3 through the eval stage.  Returns the row
    and the phase's launches."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True   # as served
    serving = {("bf16" if bf16 else "float32"): compiled_serving(
        build, bf16, smi) for bf16 in (False, True)}
    ev = compiled_eval(tmp, cli, build, g_pth, inc_pth, smi)
    total = {}
    for r in serving.values():
        add_launches(total, r["launches"])
    for r in ev["runs"].values():
        add_launches(total, r["launches"])
    f32 = serving["float32"]
    row = {"phase": "compiled_path", "serving": serving, "eval": ev,
           "summary": {
               "nvidia_smi": smi,
               "vs_nchw_eager": f32["vs_nchw_eager"],
               "request_ms_8": {k: v["ms_8"] for k, v in
                                f32["request_ms"].items()},
               "request_ms_3": {k: v["ms_3"] for k, v in
                                f32["request_ms"].items()},
               "steady_images_per_s": {
                   prec: r["steady_images_per_s"]
                   for prec, r in serving.items()},
               "enqueue_ms": {prec: {k: float(np.median(v))
                                     for k, v in r["enqueue_ms"].items()}
                              for prec, r in serving.items()},
               "capture_s": {prec: [c["capture_s"] for c in r["captures"]]
                             for prec, r in serving.items()}
               | {"eval": [c["capture_s"] for c in ev["captures"]]},
               "pool_gib": {prec: r["pool_gib"]
                            for prec, r in serving.items()}
               | {"eval": sum(c["pool_bytes"] for c in ev["captures"])
                  / 2 ** 30},
               "eval_images_per_s": {k: v["images_per_s"]
                                     for k, v in ev["runs"].items()},
               "modconv_per_replay": {
                   prec: r["modconv_per_replay"]
                   for prec, r in serving.items()}
               | {"eval": ev["runs"]["compiled"]["modconv_per_forward"]}},
           "launches": total, "wall_s": time.perf_counter() - t_phase}
    emit(row)
    return row, total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="perf_out",
                    help="directory for the per-call detail JSON")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from shgan_torch.kernels import build
    from shgan_torch.ops import conv1024, conv_resample, noise
    from shgan_torch.ops import noise_bias_act as nba
    from shgan_torch.runtime.config import model_cfg_bank
    from shgan_torch.serve import InpaintEngine
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")

    t_start = time.perf_counter()
    # ---- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _, build_s = build.build_all()
    for name in build.ENTRY_POINTS:
        build.library(name)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s})

    # ---- 2. kernels against their plain versions ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_cfg_bank()(MODEL)
    detail = {"card": smi, "model": MODEL,
              "fir_calls": {b: fir_calls(cfg, b) for b in (SERVE_BATCH, 4)}}
    layers = noise_layers(cfg)
    fir_rows, noise_rows = {}, {}
    for b in (SERVE_BATCH, 4):
        fir_rows[b] = check_fir(fir, detail["fir_calls"][b],
                                (torch.float32, torch.bfloat16))
        noise_rows[b] = check_noise(noise, b, layers)
        for site in ("enc_down_blur", "syn_up_fir", "img_upsample"):
            rows = [r for r in fir_rows[b] if r["site"] == site]
            emit({"phase": "kernel_check", "kernel": "upfirdn2d",
                  "site": site, "batch": b,
                  "res": [r["res"] for r in rows],
                  "max_abs_err": max(r["max_abs_err"] for r in rows),
                  "bf16_max_abs_err": max(r["bf16_max_abs_err"]
                                          for r in rows),
                  "nhwc_max_abs_err": max(r["nhwc_max_abs_err"]
                                          for r in rows),
                  "nhwc_bf16_max_abs_err": max(r["nhwc_bf16_max_abs_err"]
                                               for r in rows),
                  "nhwc_ms": [r["nhwc_ms"] for r in rows],
                  "nhwc_bf16_ms": [r["nhwc_bf16_ms"] for r in rows],
                  "ms": [r["ms"] for r in rows],
                  "eager_ms": [r["eager_ms"] for r in rows],
                  "bound_ms": [r["bound_ms"] for r in rows],
                  "hbm_share": [r["hbm_share"] for r in rows],
                  "bf16_ms": [r["bf16_ms"] for r in rows],
                  "bf16_hbm_share": [r["bf16_hbm_share"] for r in rows],
                  "plain_ms": [r["plain_ms"] for r in rows],
                  "library_ms": [r["library_ms"] for r in rows]})
        emit({"phase": "kernel_check", "kernel": "philox_normal", "batch": b,
              "res": [r["res"] for r in noise_rows[b]],
              "max_abs_err": max(r["max_abs_err"] for r in noise_rows[b]),
              "ms": [r["ms"] for r in noise_rows[b]],
              "eager_ms": [r["eager_ms"] for r in noise_rows[b]],
              "bound_ms": [r["bound_ms"] for r in noise_rows[b]],
              "plain_ms": [r["plain_ms"] for r in noise_rows[b]],
              "library_ms": [r["library_ms"] for r in noise_rows[b]]})
    detail["fir"] = fir_rows
    detail["noise"] = noise_rows
    epi_rows = check_epilogue(noise, nba, cfg, SERVE_BATCH)
    emit({"phase": "kernel_check", "kernel": "noise_bias_act",
          "batch": SERVE_BATCH,
          **{k: [r[k] for r in epi_rows]
             for k in ("res", "channels", "layers_per_forward", "ms",
                       "eager_ms", "bound_ms", "hbm_share", "bf16_ms",
                       "bf16_hbm_share", "plain_ms", "library_ms",
                       "library_eager_ms", "nhwc_ms", "nhwc_hbm_share",
                       "nhwc_bf16_ms", "fold_nhwc_ms")},
          "max_abs_err": max(r["max_abs_err"] for r in epi_rows),
          "fold_max_abs_err": max(r["fold_max_abs_err"] for r in epi_rows),
          "fold_bit_for_bit": True,
          "nhwc_max_abs_err": max(r["nhwc_max_abs_err"] for r in epi_rows),
          "nhwc_bf16_max_abs_err": max(r["nhwc_bf16_max_abs_err"]
                                       for r in epi_rows),
          "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in epi_rows),
          "noise_equals_k1": True})
    detail["noise_bias_act"] = epi_rows
    conv_epi_rows = check_conv_epilogue(nba, cfg, SERVE_BATCH)
    emit({"phase": "kernel_check", "kernel": "bias_lrelu",
          "batch": SERVE_BATCH,
          **{k: [r[k] for r in conv_epi_rows]
             for k in ("res", "channels", "layers_per_forward", "ms",
                       "eager_ms", "bound_ms", "hbm_share", "bf16_ms",
                       "bf16_hbm_share", "library_ms", "library_eager_ms",
                       "nhwc_ms", "nhwc_hbm_share", "nhwc_bf16_ms")},
          "bit_for_bit": True})
    detail["bias_lrelu"] = conv_epi_rows

    # K1 and K2 at the 1024² calls of a shgan_g1024 forward (eval batch)
    cfg_1024 = model_cfg_bank()(MODEL_1024)
    calls_1024 = fir_calls(cfg_1024, EVAL_BATCH)
    layers_1024 = noise_layers(cfg_1024)
    fir_1024 = check_fir(fir, [c for c in calls_1024 if c[1] == K3_RES],
                         (torch.float32, torch.bfloat16), cpu_plain=False)
    noise_1024 = check_noise(noise, EVAL_BATCH, {K3_RES: layers_1024[K3_RES]},
                             cpu_plain=False)
    for row in fir_1024:
        emit({"phase": "kernel_check", "kernel": "upfirdn2d",
              "model": MODEL_1024, "batch": EVAL_BATCH,
              **{k: row[k] for k in ("site", "res", "shape", "max_abs_err",
                                     "bf16_max_abs_err", "ms", "eager_ms",
                                     "bound_ms", "bound_by", "hbm_share",
                                     "plain_ms", "library_ms", "bf16_ms",
                                     "bf16_bound_ms", "bf16_hbm_share",
                                     "nhwc_max_abs_err",
                                     "nhwc_bf16_max_abs_err", "nhwc_ms",
                                     "nhwc_hbm_share", "nhwc_bf16_ms")}})
    for row in noise_1024:
        emit({"phase": "kernel_check", "kernel": "philox_normal",
              "model": MODEL_1024, "batch": EVAL_BATCH,
              **{k: row[k] for k in ("res", "max_abs_err", "ms", "eager_ms",
                                     "bound_ms", "bound_by", "plain_ms",
                                     "library_ms")}})
    epi_1024 = check_epilogue(
        noise, nba, cfg_1024, EVAL_BATCH,
        {k: v for k, v in epilogue_layers(cfg_1024).items() if k[0] == K3_RES})
    for row in epi_1024:
        emit({"phase": "kernel_check", "kernel": "noise_bias_act",
              "model": MODEL_1024, "batch": EVAL_BATCH,
              **{k: row[k] for k in ("res", "channels", "max_abs_err",
                                     "bf16_max_abs_err", "ms", "eager_ms",
                                     "bound_ms", "bound_by", "hbm_share",
                                     "bf16_ms", "bf16_hbm_share", "plain_ms",
                                     "library_ms", "library_eager_ms",
                                     "nhwc_max_abs_err",
                                     "nhwc_bf16_max_abs_err", "nhwc_ms",
                                     "nhwc_hbm_share", "nhwc_bf16_ms",
                                     "fold_max_abs_err", "fold_nhwc_ms")}})
    conv_rows = check_conv3(conv1024, conv_resample)
    for row in conv_rows:
        emit({"phase": "kernel_check", "kernel": "conv3x3_lowch", **row})
    # K2 at the discriminator's calls of the training path (comodgan_d256,
    # batch 8): the blur before each strided conv and the 1x1 skips'
    # down = 2, the resampling tiles' main caller
    d_calls = [c for c in train_fir_calls(
        model_cfg_bank()(TRAIN_G), model_cfg_bank()(TRAIN_D), TRAIN_BATCH)
        if c[0].startswith("d_")]
    fir_d = check_fir(fir, d_calls, (torch.float32, torch.bfloat16),
                      cpu_plain=False, nhwc=False)   # training: NCHW only
    for site in ("d_down_blur", "d_skip_down"):
        rows = [r for r in fir_d if r["site"] == site]
        emit({"phase": "kernel_check", "kernel": "upfirdn2d",
              "model": TRAIN_D, "site": site, "batch": TRAIN_BATCH,
              "down": rows[0]["down"],
              **{k: [r[k] for r in rows]
                 for k in ("res", "ms", "eager_ms", "bound_ms", "hbm_share",
                           "bf16_ms", "bf16_hbm_share", "plain_ms",
                           "library_ms")},
              "max_abs_err": max(r["max_abs_err"] for r in rows),
              "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in rows)})
    detail.update(fir_1024=fir_1024, noise_1024=noise_1024,
                  noise_bias_act_1024=epi_1024, conv3x3_lowch=conv_rows,
                  fir_d=fir_d)

    # ---- 3. the main path ------------------------------------------------
    # PyTorch's defaults for serving: cuDNN may use TF32 for float32 convs
    torch.backends.cudnn.allow_tf32 = True
    res = int(cfg["args"]["synthesis"]["args"]["resolution"])
    t0 = time.perf_counter()
    engine = InpaintEngine(MODEL, device="cuda", batch_size=SERVE_BATCH,
                           noise_mode="random", seed=0, latency_batches=(4,))
    noise_reaches_image(engine.G)
    setup_s = time.perf_counter() - t0
    reqs = requests(res, seed=1)
    for imgs, masks in reqs[1:]:   # first call at each bucket: set-up
        engine.inpaint(imgs, masks, start_index=10_000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    build.reset_launches()
    outs, lat_ms, start = [], [], 0
    for imgs, masks in reqs:
        t0 = time.perf_counter()
        outs.append(engine.inpaint(imgs, masks, start_index=start))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        start += imgs.shape[0]
    launches = dict(build.launches)
    nhwc = nhwc_rule(build, launches, 1.0, "main path")

    per_fwd_fir = len(detail["fir_calls"][SERVE_BATCH])
    per_fwd_noise = sum(layers.values())
    per_fwd_conv = sum(encoder_conv_layers(cfg).values())
    # every synthesis layer's epilogue is one fused launch, every encoder
    # conv's bias and activation one bias_lrelu launch; K1 itself is off
    # the main path
    want_serve = {"upfirdn2d": 3 * per_fwd_fir, "upfirdn2d_grad": 0,
                  "philox_normal": 0, "conv3x3_lowch": 0,
                  "noise_bias_act": 3 * per_fwd_noise,
                  "noise_bias_act_grad": 0, "bias_lrelu": 3 * per_fwd_conv}
    if launches != want_serve:
        raise AssertionError(f"launch counts {launches}, expected "
                             f"{want_serve}")
    for (imgs, masks), out in zip(reqs, outs):
        if out.shape != imgs.shape or out.dtype != np.uint8:
            raise AssertionError(f"output {out.shape} {out.dtype}")
        keep = np.broadcast_to(masks[:, None] > 0.5, out.shape)
        if not np.array_equal(out[keep], quantized(imgs)[keep]):
            raise AssertionError("known pixels differ from the input")
    again, start = [], 0
    for imgs, masks in reqs:
        again.append(engine.inpaint(imgs, masks, start_index=start))
        start += imgs.shape[0]
    if not all(np.array_equal(a, b) for a, b in zip(outs, again)):
        raise AssertionError("two runs with the same seed differ")
    # the noise reaches the image: another start index draws other noise
    other = engine.inpaint(*reqs[0], start_index=1)
    if np.array_equal(other, outs[0]):
        raise AssertionError("random noise does not reach the image")

    imgs8, masks8 = reqs[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        engine.inpaint(imgs8, masks8, start_index=8 * i)
    steady_s = time.perf_counter() - t0
    n_img = sum(r[0].shape[0] for r in reqs)
    emit({"phase": "main_path", "model": MODEL, "batch_size": SERVE_BATCH,
          "path": engine.path(),
          "pool_gib": engine.compiled.pool_bytes() / 2 ** 30,
          "buckets": engine.buckets, "requests_rows": [8, 8, 3],
          "latency_ms": lat_ms, "images_per_s": n_img / (sum(lat_ms) / 1e3),
          "steady_images_per_s": 40 / steady_s, "launches": launches,
          "nhwc_launches": nhwc,
          "nhwc_share": build.nhwc_share(launches, nhwc),
          "expected_per_forward": {k: v // 3 for k, v in want_serve.items()},
          "setup_s": setup_s, "cudnn_tf32": True,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "deterministic": True, "known_pixels_exact": True})

    # ---- 4. whole-path parity, card vs CPU ----------------------------------
    torch.backends.cudnn.allow_tf32 = False
    state = {k: v.cpu() for k, v in engine.G.state_dict().items()}
    engine.close()
    del engine
    torch.cuda.empty_cache()
    imgs, masks = reqs[2][0][:1], reqs[2][1][:1]
    got = {}
    for dev in ("cuda", "cpu"):
        e = InpaintEngine(MODEL, device=dev, batch_size=1, noise_mode="const",
                          seed=0)
        e.G.load_state_dict(state, strict=True)
        t0 = time.perf_counter()
        got[dev] = e.inpaint(imgs, masks).astype(np.int16)
        got[dev + "_s"] = time.perf_counter() - t0
        e.close()
        del e
    d = np.abs(got["cuda"] - got["cpu"])
    within1 = float((d <= 1).mean())
    emit({"phase": "parity", "model": MODEL, "batch": 1,
          "noise_mode": "const", "tf32": False, "within_1": within1,
          "max_abs_diff": int(d.max()), "cuda_s": got["cuda_s"],
          "cpu_s": got["cpu_s"]})
    if within1 < 0.999 or d.max() > 2:
        raise AssertionError(f"card vs CPU: {within1:.6f} within 1, "
                             f"max {int(d.max())}")

    # ---- 5. the eval path at shgan_g1024 ------------------------------------
    # (PyTorch's defaults again: cuDNN may use TF32 for float32 convs)
    torch.backends.cudnn.allow_tf32 = True
    from shgan_torch import main as cli
    from shgan_torch.eval.inception import random_inception_state_dict
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        g_pth = os.path.join(tmp, f"{MODEL_1024}_random.pth")
        inc_pth = os.path.join(tmp, "inception_random.pth")
        t0 = time.perf_counter()
        random_weights(MODEL_1024, g_pth)
        torch.save({k: torch.from_numpy(v) for k, v in
                    random_inception_state_dict(0).items()}, inc_pth)
        weights_s = time.perf_counter() - t0
        ecfg = eval_config(tmp, g_pth, inc_pth, EVAL_IMAGES, "log")
        torch.cuda.reset_peak_memory_stats()
        # the stage as the CLI runs it: no fence inside the batch loop
        build.reset_launches()
        t0 = time.perf_counter()
        rv = cli.run(ecfg)
        eval_s = time.perf_counter() - t0
        eval_launches = dict(build.launches)
        eval_nhwc = nhwc_rule(build, eval_launches, 1.0, "eval path")
        n_batches = EVAL_IMAGES // EVAL_BATCH
        want = {"conv3x3_lowch": 2 * n_batches,
                "upfirdn2d": len(calls_1024) * n_batches,
                "upfirdn2d_grad": 0, "philox_normal": 0,
                "noise_bias_act": sum(layers_1024.values()) * n_batches,
                "noise_bias_act_grad": 0,
                "bias_lrelu": sum(encoder_conv_layers(cfg_1024).values())
                * n_batches}
        if eval_launches != want:
            raise AssertionError(f"eval launch counts {eval_launches}, "
                                 f"expected {want}")
        with open(os.path.join(ecfg["eval"]["log_dir"], "result.json")) as f:
            result = json.load(f)
        metrics = {k: result[k][k] for k in ("fid", "psnr", "ssim")}
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"result.json: {metrics}")
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        timing = rv["timing"]
        # the images after batch 0 (its first-use set-up) over the loop's
        # wall time after batch 0, the evaluators' drain included
        loop_s = sum(timing["batch_s"][1:]) + timing["drain_s"]
        emit({"phase": "eval_path", "model": MODEL_1024,
              "experiment": "shgan_synthetic256_eval", "images": EVAL_IMAGES,
              "batch": EVAL_BATCH, "resolution": K3_RES,
              "noise_mode": "random", "cudnn_tf32": True, "metrics": metrics,
              "launches": eval_launches, "nhwc_launches": eval_nhwc,
              "nhwc_share": build.nhwc_share(eval_launches, eval_nhwc),
              "expected_per_forward": {k: v // n_batches
                                       for k, v in want.items()},
              "images_per_s": EVAL_BATCH * (n_batches - 1) / loop_s,
              "images_timed": EVAL_BATCH * (n_batches - 1),
              "batch_s": timing["batch_s"], "drain_s": timing["drain_s"],
              "stage_s": eval_s, "weights_s": weights_s,
              "peak_mem_gib": peak_gib})

        # ---- 6. K3 in place: the same forward with K3 and with cuDNN ----------
        torch.backends.cudnn.allow_tf32 = False
        in_place = k3_in_place(ecfg, g_pth)

        # ---- 7. the command line on the card --------------------------------
        env = dict(os.environ, SHGAN_LOG_ROOT=os.path.join(tmp, "cli"))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "shgan_torch.main", "--experiment",
             "shgan_synthetic256_eval", "--debug", "--eval", "0"],
            env=env, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"CLI exit {r.returncode}:\n{r.stdout}\n"
                                 f"{r.stderr}")
        res_json = os.path.join(tmp, "cli", "shgan_synthetic256_inpainting",
                                "0", "shgan_synthetic256", "result.json")
        with open(res_json) as f:
            cli_result = json.load(f)
        emit({"phase": "cli", "argv": r.args[1:], "exit": r.returncode,
              "result": cli_result, "wall_s": time.perf_counter() - t0})

        # ---- 8. the training path at shgan_g256 + comodgan_d256 -------------
        torch.backends.cudnn.allow_tf32 = False
        tcfg = train_config(tmp, TRAIN_STEPS)
        g256 = tcfg["model_g"]
        tcalls = train_fir_calls(g256, tcfg["model_d"], TRAIN_BATCH)
        fir_grad_rows = check_fir_grad(fir, tcalls)
        for site in ("enc_down_blur", "syn_up_fir", "img_upsample",
                     "d_down_blur", "d_skip_down"):
            rows = [r for r in fir_grad_rows if r["site"] == site]
            emit({"phase": "kernel_check", "kernel": "upfirdn2d_backward",
                  "site": site, "batch": TRAIN_BATCH,
                  **{k: [r[k] for r in rows]
                     for k in ("res", "ms", "eager_ms", "bound_ms",
                               "hbm_share", "plain_ms", "library_ms")},
                  "max_abs_err": max(r["max_abs_err"] for r in rows)})
        epi_grad_rows = check_epilogue_grad(noise, nba, g256, TRAIN_BATCH,
                                            TRAIN_BATCH // 2)
        emit({"phase": "kernel_check", "kernel": "noise_bias_act_grad",
              "batch": TRAIN_BATCH,
              **{k: [r[k] for r in epi_grad_rows]
                 for k in ("res", "channels", "layers_per_forward", "ms",
                           "eager_ms", "bound_ms", "hbm_share", "plain_ms",
                           "library_ms", "mask_ms")},
              "max_abs_err": max(r["max_abs_err"] for r in epi_grad_rows),
              "sums_max_rel_err": max(r["sums_max_rel_err"]
                                      for r in epi_grad_rows),
              "noise_equals_k1": True})
        detail.update(fir_grad=fir_grad_rows, noise_bias_act_grad=epi_grad_rows)
        # the path with PyTorch's defaults (cuDNN may use TF32), as served
        torch.backends.cudnn.allow_tf32 = True
        train_row, tcfg = train_path(tmp, cli, build)
        # training runs eagerly under autograd: the NCHW maps alone
        nhwc_rule(build, None, 0.0, "training")
        train_launches = {k: sum(s[k] for s in train_row["launches_per_step"])
                          for k in train_row["launches_per_step"][0]}
        torch.backends.cudnn.allow_tf32 = False
        parity_row = train_parity(tcfg)
        detail.update(train_path=train_row, train_parity=parity_row)

        # ---- 9. the published eval protocol at shgan_g256 --------------------
        # (PyTorch's defaults, as a user runs it: cuDNN may use TF32)
        torch.backends.cudnn.allow_tf32 = True
        full_row = fullmetrics_path(tmp, cli, build, fir, inc_pth)
        full_launches = full_row["launches"]
        detail.update(fullmetrics_path=full_row)

        # ---- 10. shgan_ffhq256_train as configured ---------------------------
        # (PyTorch's defaults, as a user trains: cuDNN may use TF32)
        config_row = train_config_path(tmp, cli, build, fir, inc_pth)
        config_launches = {
            k: sum(w[k] for w in config_row["launches_per_step"]
                   + config_row["launches_outside"])
            for k in config_row["launches_outside"][0]}
        detail.update(train_config_path=config_row)

        # ---- 11. the bf16 throughput configuration ---------------------------
        bf16_row, egr16, fgr16, bf16_total = bf16_path(
            tmp, cli, build, fir, nba, noise, inc_pth, tcfg, fir_grad_rows,
            epi_grad_rows)
        detail.update(bf16_path=bf16_row, noise_bias_act_grad_bf16=egr16,
                      fir_grad_bf16=fgr16)

        # ---- 12. several devices --------------------------------------------
        md_row, md_offset, md_total = multi_device_path(tmp, build, noise,
                                                        nba, inc_pth)
        detail.update(multi_device_path=md_row, row_offset=md_offset)

        # ---- 13. spatial (H) sharding ---------------------------------------
        sp_row, sp_kernels, sp_total = spatial_path(tmp, noise, nba,
                                                    conv1024)
        detail.update(spatial_path=sp_row, slab_windows=sp_kernels)

        # ---- 14. per-block rematerialization (train.remat) ------------------
        remat_row, remat_total = remat_path(tmp)
        detail.update(remat_path=remat_row)

        # ---- 15. the compiled forward against the eager one -----------------
        torch.cuda.empty_cache()
        compiled_row, compiled_total = compiled_path(tmp, cli, build, g_pth,
                                                     inc_pth, smi)
        detail.update(compiled_path=compiled_row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 16. the kernels line -----------------------------------------------
    detail.update(eval_launches=eval_launches, k3_in_place=in_place,
                  train_launches=train_launches,
                  fullmetrics_launches=full_launches,
                  train_config_launches=config_launches)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke_detail.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    fr, nr = fir_rows[SERVE_BATCH], noise_rows[SERVE_BATCH]
    er, e1 = epi_rows, epi_1024[0]
    wsum = lambda rows, k: sum(r[k] * r.get("layers_per_forward", 1)  # noqa
                               for r in rows)
    k3 = conv_rows[0]   # [EVAL_BATCH, 32, 1024, 1024], float32
    fgr, egr = fir_grad_rows, epi_grad_rows
    # K2's resampling calls (up = 2 or down = 2): D's skips at the train
    # batch, the skip-image upsample of the serving forward, and the
    # backwards of the training path's calls that resample
    dsk = [r for r in fir_d if r["site"] == "d_skip_down"]
    ups = [r for r in fr if r["up"] == 2]
    rsg = [r for r in fgr if 2 in (r["up"], r["down"])]

    def resampling(prefix, rows, bf16=True, nhwc=False):
        key = "nhwc_ms" if nhwc else "ms"
        ms = sum(r[key] for r in rows)
        out = {f"{prefix}_ms": ms,
               f"{prefix}_bound_ms": sum(r["bound_ms"] for r in rows),
               f"{prefix}_hbm_share": sum(r["bytes_ms"] for r in rows) / ms,
               f"{prefix}_library_ms": sum(r["library_ms"] for r in rows)}
        if bf16:
            out[f"{prefix}_bf16_ms"] = sum(
                r["nhwc_bf16_ms" if nhwc else "bf16_ms"] for r in rows)
        if nhwc:
            out[f"{prefix}_nchw_ms"] = sum(r["ms"] for r in rows)
        return out

    def by_map(rows, weigh=wsum):
        """The main figures from the NHWC map the compiled forward runs,
        the NCHW map's (the eager paths and training) beside them."""
        return {"max_abs_err": max(r["nhwc_max_abs_err"] for r in rows),
                "ms": weigh(rows, "nhwc_ms"),
                "bf16_ms": weigh(rows, "nhwc_bf16_ms"),
                "nchw_max_abs_err": max(r["max_abs_err"] for r in rows),
                "nchw_ms": weigh(rows, "ms"),
                "nchw_bf16_ms": weigh(rows, "bf16_ms"),
                "nchw_eager_ms": weigh(rows, "eager_ms")}
    maps = ("ms, bf16_ms and max_abs_err: the NHWC map the compiled forward "
            "runs (nchw_*: the NCHW map of the eager paths and training, "
            "bit for bit the same results; nchw_eager_ms not in a graph)")
    emit({"kernels": [
        {"name": "upfirdn2d", "route": "cuda",
         "source": "shgan_torch/csrc/upfirdn2d.cu",
         "replaces": "shgan_tpu/ops/fir_pallas.py:100",
         "replaces_function": "_pallas_fir",
         "launches": launches["upfirdn2d"],
         "launches_eval_path": eval_launches["upfirdn2d"],
         "launches_train_path": train_launches["upfirdn2d"],
         "launches_fullmetrics_path": full_launches["upfirdn2d"],
         "launches_train_config_path": config_launches["upfirdn2d"],
         "launches_bf16_path": bf16_total["upfirdn2d"],
         "launches_multi_device_path": md_total.get("upfirdn2d", 0),
         "launches_spatial_path": sp_total.get("upfirdn2d", 0),
         "launches_remat_path": remat_total.get("upfirdn2d", 0),
         "launches_compiled_path": compiled_total.get("upfirdn2d", 0),
         **by_map(fr),
         "max_abs_err": max(r["nhwc_max_abs_err"] for r in fr + fir_1024),
         "nchw_max_abs_err": max(r["max_abs_err"] for r in fr + fir_1024),
         "plain_ms": wsum(fr, "plain_ms"),
         "bound_ms": wsum(fr, "bound_ms"), "bound_by": bound_by(fr),
         "hbm_share": wsum(fr, "bytes_ms") / wsum(fr, "nhwc_ms"),
         "library_ms": wsum(fr, "library_ms"),
         **resampling("d_skip", dsk),
         **resampling("img_upsample", ups, nhwc=True),
         "scope": f"all {len(fr)} calls of one {MODEL} forward at batch "
                  f"{SERVE_BATCH}, float32 (bf16_ms: in bfloat16); {maps}; "
                  f"d_skip_*: the {len(dsk)} 1x1 skips (down = 2) of one "
                  f"{TRAIN_D} forward at batch {TRAIN_BATCH}, library_ms "
                  "cuDNN's stride-2 depthwise conv2d; img_upsample_*: the "
                  f"{len(ups)} skip-image upsamples (up = 2) of the {MODEL} "
                  "forward on the NHWC map (img_upsample_nchw_ms: the NCHW "
                  "map), library_ms cuDNN's stride-2 conv_transpose2d; "
                  "launches over the serving path "
                  f"(and over the {MODEL_1024} eval path)"},
        {"name": "philox_normal", "route": "cuda",
         "source": "shgan_torch/csrc/noise.cu",
         "replaces": "shgan_tpu/ops/noise.py:68",
         "replaces_function": "_pallas_normal",
         "launches": launches["philox_normal"],
         "launches_eval_path": eval_launches["philox_normal"],
         "launches_train_path": train_launches["philox_normal"],
         "launches_fullmetrics_path": full_launches["philox_normal"],
         "launches_train_config_path": config_launches["philox_normal"],
         "launches_bf16_path": bf16_total["philox_normal"],
         "launches_multi_device_path": md_total.get("philox_normal", 0),
         "launches_spatial_path": sp_total.get("philox_normal", 0),
         "launches_remat_path": remat_total.get("philox_normal", 0),
         "launches_compiled_path": compiled_total.get("philox_normal", 0),
         "max_abs_err": max(r["max_abs_err"] for r in nr + noise_1024),
         "ms": wsum(nr, "ms"), "eager_ms": wsum(nr, "eager_ms"),
         "plain_ms": wsum(nr, "plain_ms"),
         "bound_ms": wsum(nr, "bound_ms"), "bound_by": bound_by(nr),
         "library_ms": wsum(nr, "library_ms"),
         "scope": f"all {per_fwd_noise} noise layers of one {MODEL} forward "
                  f"at batch {SERVE_BATCH}, the noise-only entry point; "
                  "launches over the serving path (and over the "
                  f"{MODEL_1024} eval path): none, the main path draws the "
                  "noise inside noise_bias_act"},
        {"name": "noise_bias_act", "route": "cuda",
         "source": "shgan_torch/csrc/noise_bias_act.cu",
         "replaces": "shgan_tpu/ops/noise.py:68",
         "replaces_function": "_pallas_normal, with the PyTorch chain that "
                              "consumed its noise",
         "launches": launches["noise_bias_act"],
         "launches_eval_path": eval_launches["noise_bias_act"],
         "launches_train_path": train_launches["noise_bias_act"],
         "launches_fullmetrics_path": full_launches["noise_bias_act"],
         "launches_train_config_path": config_launches["noise_bias_act"],
         "launches_bf16_path": bf16_total["noise_bias_act"],
         "launches_multi_device_path": md_total.get("noise_bias_act", 0),
         "launches_spatial_path": sp_total.get("noise_bias_act", 0),
         "launches_remat_path": remat_total.get("noise_bias_act", 0),
         "launches_compiled_path": compiled_total.get("noise_bias_act", 0),
         **by_map(er),
         "max_abs_err": max(r["nhwc_max_abs_err"] for r in er + epi_1024),
         "nchw_max_abs_err": max(r["max_abs_err"] for r in er + epi_1024),
         "plain_ms": wsum(er, "plain_ms"),
         "bound_ms": wsum(er, "bound_ms"), "bound_by": bound_by(er),
         "hbm_share": wsum(er, "bytes_ms") / wsum(er, "nhwc_ms"),
         "nchw_hbm_share": wsum(er, "bytes_ms") / wsum(er, "ms"),
         "library_ms": wsum(er, "library_ms"),
         "library_eager_ms": wsum(er, "library_eager_ms"),
         "ms_1024": e1["nhwc_ms"] * e1["layers_per_forward"],
         "nchw_ms_1024": e1["ms"] * e1["layers_per_forward"],
         "bound_ms_1024": e1["bound_ms"] * e1["layers_per_forward"],
         "library_ms_1024": e1["library_ms"] * e1["layers_per_forward"],
         "scope": f"all {per_fwd_noise} synthesis layers of one {MODEL} "
                  f"forward at batch {SERVE_BATCH}, random noise, float32 "
                  "(bf16_ms: in bfloat16; *_1024: the 1024² layers of one "
                  f"{MODEL_1024} forward at batch {EVAL_BATCH}); {maps}, "
                  "the NHWC map's key a noise-table row; "
                  "library_ms: the unfused path on the same inputs, K1 "
                  "plus the PyTorch chain (no single PyTorch call computes "
                  "the function); launches over the serving path (and over "
                  f"the {MODEL_1024} eval path)"},
        {"name": "bias_lrelu", "route": "cuda",
         "source": "shgan_torch/csrc/noise_bias_act.cu",
         "replaces": None,
         "replaces_function": "the Conv2dLayers' bias add and lrelu_agc "
                              "(PyTorch ops; XLA fused them in JAX)",
         "launches": launches["bias_lrelu"],
         "launches_eval_path": eval_launches["bias_lrelu"],
         "launches_train_path": train_launches["bias_lrelu"],
         "launches_fullmetrics_path": full_launches["bias_lrelu"],
         "launches_train_config_path": config_launches["bias_lrelu"],
         "launches_bf16_path": bf16_total["bias_lrelu"],
         "launches_multi_device_path": md_total.get("bias_lrelu", 0),
         "launches_spatial_path": sp_total.get("bias_lrelu", 0),
         "launches_remat_path": remat_total.get("bias_lrelu", 0),
         "launches_compiled_path": compiled_total.get("bias_lrelu", 0),
         **by_map(conv_epi_rows),
         "bound_ms": wsum(conv_epi_rows, "bound_ms"),
         "bound_by": bound_by(conv_epi_rows),
         "hbm_share": wsum(conv_epi_rows, "bytes_ms")
         / wsum(conv_epi_rows, "nhwc_ms"),
         "nchw_hbm_share": wsum(conv_epi_rows, "bytes_ms")
         / wsum(conv_epi_rows, "ms"),
         "library_ms": wsum(conv_epi_rows, "library_ms"),
         "library_eager_ms": wsum(conv_epi_rows, "library_eager_ms"),
         "scope": f"all {per_fwd_conv} encoder convs of one {MODEL} forward "
                  f"at batch {SERVE_BATCH}, float32, bit for bit the "
                  f"chain (bf16_ms: in bfloat16); {maps}; library_ms: the "
                  "PyTorch "
                  "chain on the same inputs; launches over the serving "
                  f"path (and over the {MODEL_1024} eval path)"},
        {"name": "conv3x3_lowch", "route": "cuda",
         "source": "shgan_torch/csrc/conv3x3_lowch.cu",
         "replaces": "shgan_tpu/ops/conv1024.py:101",
         "replaces_function": "conv3x3_lowch",
         "launches": eval_launches["conv3x3_lowch"],
         "launches_train_path": train_launches["conv3x3_lowch"],
         "launches_fullmetrics_path": full_launches["conv3x3_lowch"],
         "launches_train_config_path": config_launches["conv3x3_lowch"],
         "launches_bf16_path": bf16_total["conv3x3_lowch"],
         "launches_multi_device_path": md_total.get("conv3x3_lowch", 0),
         "launches_spatial_path": sp_total.get("conv3x3_lowch", 0),
         "launches_remat_path": remat_total.get("conv3x3_lowch", 0),
         "launches_compiled_path": compiled_total.get("conv3x3_lowch", 0),
         **by_map([k3], lambda rows, k: 2 * rows[0][k]),
         "max_abs_err": max(r["nhwc_max_abs_err"] for r in conv_rows),
         "nchw_max_abs_err": max(r["max_abs_err"] for r in conv_rows),
         "plain_ms": 2 * k3["plain_ms"],
         "bound_ms": 2 * k3["bound_ms"], "bound_by": k3["bound_by"],
         "floor_3xtf32_ms": 2 * k3["floor_3xtf32_ms"],
         "library_ms": 2 * k3["library_ms"],
         "library_tf32_ms": 2 * k3["library_tf32_ms"],
         "bf16_bound_ms": 2 * k3["bf16_bound_ms"],
         "bf16_library_ms": 2 * k3["bf16_library_ms"],
         "scope": f"both calls of one {MODEL_1024} forward at batch "
                  f"{EVAL_BATCH} ([{EVAL_BATCH},32,1024,1024] 32->32), "
                  "float32, TF32 off (library_tf32_ms: cuDNN with TF32; "
                  "bound: bytes or operations at the TF32 tensor-core rate; "
                  "floor_3xtf32_ms: three TF32 products a multiply-add; "
                  f"bf16_*: in bfloat16); {maps}; "
                  f"launches over the {MODEL_1024} eval path"},
        {"name": "upfirdn2d_backward", "route": "cuda",
         "source": "shgan_torch/csrc/upfirdn2d.cu",
         "replaces": "shgan_tpu/ops/fir_pallas.py:150",
         "replaces_function": "the custom VJP of _pallas_fir (_make_op's "
                              "bwd, XLA on the TPU)",
         "launches": train_launches["upfirdn2d_grad"],
         "launches_fullmetrics_path": full_launches["upfirdn2d_grad"],
         "launches_train_config_path": config_launches["upfirdn2d_grad"],
         "launches_bf16_path": bf16_total["upfirdn2d_grad"],
         "launches_multi_device_path": md_total.get("upfirdn2d_grad", 0),
         "launches_spatial_path": sp_total.get("upfirdn2d_grad", 0),
         "launches_remat_path": remat_total.get("upfirdn2d_grad", 0),
         "launches_compiled_path": compiled_total.get("upfirdn2d_grad", 0),
         "max_abs_err": max(r["max_abs_err"] for r in fgr),
         "ms": sum(r["ms"] for r in fgr),
         "eager_ms": sum(r["eager_ms"] for r in fgr),
         "plain_ms": sum(r["plain_ms"] for r in fgr),
         "bound_ms": sum(r["bound_ms"] for r in fgr),
         "bound_by": bound_by(fgr),
         "hbm_share": sum(r["bytes_ms"] for r in fgr)
         / sum(r["ms"] for r in fgr),
         "library_ms": (None if any(r["library_ms"] is None for r in fgr)
                        else sum(r["library_ms"] for r in fgr)),
         **resampling("resample", rsg, bf16=False),
         "resample_bf16_ms": sum(r["ms"] for r in fgr16),
         "resample_bf16_bound_ms": sum(r["bound_ms"] for r in fgr16),
         "resample_bf16_hbm_share": sum(r["bytes_ms"] for r in fgr16)
         / sum(r["ms"] for r in fgr16),
         "resample_bf16_library_ms": (
             None if any(r["library_ms"] is None for r in fgr16)
             else sum(r["library_ms"] for r in fgr16)),
         "resample_bf16_plain_ms": sum(r["plain_ms"] for r in fgr16),
         "resample_bf16_max_abs_err": max(r["max_abs_err"] for r in fgr16),
         "scope": f"the backward of each of the {len(fgr)} K2 calls of one "
                  f"{g256['name']} forward and one {tcfg['model_d']['name']} "
                  f"forward at batch {TRAIN_BATCH}, float32 (kernel K2 on "
                  "the cotangent: reversed taps, up and down swapped); "
                  "plain_ms: autograd of fir_plain's backward; library_ms: "
                  "the cuDNN call computing the same gradient; resample_*: "
                  f"the {len(rsg)} backwards that resample (up = 2 or "
                  "down = 2; resample_bf16_*: the same calls in bfloat16); "
                  "launches: "
                  f"K2's derivative calls over the {TRAIN_STEPS}-step train "
                  "path (backward and second order)"},
        {"name": "noise_bias_act_grad", "route": "cuda",
         "source": "shgan_torch/csrc/noise_bias_act.cu",
         "replaces": "shgan_tpu/ops/noise.py:68",
         "replaces_function": "JAX autodiff of the chain after "
                              "_pallas_normal (the noise has no gradient)",
         "launches": train_launches["noise_bias_act_grad"],
         "launches_fullmetrics_path": full_launches["noise_bias_act_grad"],
         "launches_train_config_path": config_launches[
             "noise_bias_act_grad"],
         "launches_bf16_path": bf16_total["noise_bias_act_grad"],
         "launches_multi_device_path": md_total.get("noise_bias_act_grad", 0),
         "launches_spatial_path": sp_total.get("noise_bias_act_grad", 0),
         "launches_remat_path": remat_total.get("noise_bias_act_grad", 0),
         "launches_compiled_path": compiled_total.get("noise_bias_act_grad", 0),
         "max_abs_err": max(r["max_abs_err"] for r in egr),
         "sums_max_rel_err": max(r["sums_max_rel_err"] for r in egr),
         "ms": wsum(egr, "ms"), "eager_ms": wsum(egr, "eager_ms"),
         "mask_ms": wsum(egr, "mask_ms"),
         "plain_ms": wsum(egr, "plain_ms"),
         "bound_ms": wsum(egr, "bound_ms"), "bound_by": bound_by(egr),
         "hbm_share": wsum(egr, "bytes_ms") / wsum(egr, "ms"),
         "library_ms": wsum(egr, "library_ms"),
         "bf16_ms": wsum(egr16, "ms"),
         "bf16_eager_ms": wsum(egr16, "eager_ms"),
         "bf16_mask_ms": wsum(egr16, "mask_ms"),
         "bf16_plain_ms": wsum(egr16, "plain_ms"),
         "bf16_bound_ms": wsum(egr16, "bound_ms"),
         "bf16_hbm_share": wsum(egr16, "bytes_ms") / wsum(egr16, "ms"),
         "bf16_library_ms": wsum(egr16, "library_ms"),
         "bf16_max_abs_err": max(r["max_abs_err"] for r in egr16),
         "bf16_sums_max_rel_err": max(r["sums_max_rel_err"] for r in egr16),
         "float32_ms_bf16_layers": wsum([r for r in egr if r["res"] > 16],
                                        "ms"),
         "scope": f"all {sum(r['layers_per_forward'] for r in egr)} "
                  f"synthesis layers of one {g256['name']} backward at batch "
                  f"{TRAIN_BATCH}, random noise, float32, the full mode "
                  f"(mask_ms: the mask-only mode at batch {TRAIN_BATCH // 2}"
                  "); library_ms: autograd of the PyTorch chain "
                  "(noise_bias_act_plain) on the same inputs, eager; "
                  "bf16_*: bfloat16 I/O at the "
                  f"{sum(r['layers_per_forward'] for r in egr16)} layers "
                  "at 32²-256² (the bf16 blocks; float32_ms_bf16_layers: "
                  "the float32 kernel at the same layers), bound at 6 bytes "
                  "an element, library autograd of the chain in bf16; "
                  f"launches over the {TRAIN_STEPS}-step train path "
                  "(launches_bf16_path: over phase 11)"},
    ], "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
