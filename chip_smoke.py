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
   PyTorch chain) on the same inputs; K2 at the discriminator's calls of
   the training path (``comodgan_d256`` at batch 8: the blurs and the 1×1
   skips' down = 2, the resampling tiles), float32 and bf16, beside cuDNN's
   stride-2 depthwise ``conv2d``;
3. serving path: ``InpaintEngine("shgan_g512", device="cuda",
   batch_size=8)`` with random noise (every ``noise_strength`` set to 0.1
   so the noise reaches the image) answers requests of 8, 8 and 3 rows;
   launch counts over exactly those requests (the fused epilogue 15 a
   forward, K1 itself none); the composite contract and run-to-run
   determinism; latency and images/s;
4. parity: the same weights with constant noise at batch 1 on the card and
   on the CPU (the plain versions), uint8 composites compared;
5. eval path: ``shgan_synthetic256_eval`` assembled by the CLI's
   ``build_config`` with the model swapped to ``shgan_g1024`` (random
   weights loaded strictly from a ``.pth``), 96 synthetic 1024² images
   from a pool of 4, batch 4, ``pallas_conv1024: true``, FID (random
   Inception weights from a pytorch-fid style ``.pth``), PSNR and SSIM,
   run by the CLI's ``run``; launch counts of every kernel over exactly
   that run (K3 2, K2 24, the fused epilogue 17 a forward, K1 none),
   finite metrics in ``result.json``, images/s and peak memory; then the
   same run again with ``SHGAN_EVAL_TIMING=1`` for the
   fenced per-batch split (pipe wait, generator, metrics);
6. K3 in place: one ``shgan_g1024`` batch with constant noise, TF32 off,
   with the conv1024 switch on (K3) and off (cuDNN): composites compared,
   forwards timed;
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
   (step 0 with both regularizers, 4 with the path-length penalty),
   ``SHGAN_TRAIN_TIMING=1``: per-step ms by phase (fenced), images/s over
   steps 1–5, peak memory, launches per step checked against counts worked
   out from the modules (the counts set to 0 as each step starts and read
   as it ends), G_ema's image grids (``demo/fakes_init.png`` and the final
   one) with their own launches (three forwards each, none between the
   steps), ``stats.jsonl`` a record a tick keyed by ``step``, finite
   losses, moved weights, ``pl_mean > 0``;
   the final snapshot reloaded and one step from it equal to the same step
   from memory (cuDNN deterministic); one Gmain + Dmain + R1 gradient at
   batch 2 on the card and on the CPU, TF32 off, each leaf within 1e-3 of
   its norm;
9. the kernels line ``{"kernels": [...]}``;
10. last line: ``{"ok": true, "device": {...}}``.

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


def check_fir(fir, calls, dtype_list, cpu_plain=True):
    """K2 against its plain version at each of ``calls`` (``fir_calls``
    or ``train_fir_calls`` rows)."""
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
    chain) timed on the same inputs."""
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
        rows.append(row)
        del x, xk, xb, xbk, y, yb, want, wb, zero, k1
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
    bfloat16.  TF32 is off, except where a row says so."""
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
        if flip:   # the routing of ops/conv_resample._conv2d, switch on
            conv1024.set_conv1024_impl("pallas")
            try:
                y = conv_resample._conv2d(x, w, padding=(1, 1),
                                          flip_weight=False)
            finally:
                conv1024.set_conv1024_impl("xla")
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
              pallas_conv1024=True, noise_mode="random",
              output_sample_images=False, log_display=images,
              evaluator=[{"type": "fid",
                          "args": {"detector_weights": inc_pth}},
                         {"type": "psnr", "args": {"for_dataset": None,
                                                   "rgb_range": 1}},
                         {"type": "ssim", "args": {"window_size": 11}}])
    return cfg


def k3_in_place(cfg, g_pth):
    """One ``shgan_g1024`` batch with constant noise, TF32 off: the forward
    with the switch on (K3) and off (cuDNN), composites compared and both
    forwards timed, in turns on, off, off, on."""
    from shgan_torch.data.datasets import get_dataset
    from shgan_torch.data.formatters import get_formatter
    from shgan_torch.data.pipeline import EvalPipeline
    from shgan_torch.data.transforms import wrap_formatter
    from shgan_torch.kernels import build
    from shgan_torch.models.infer import composite_forward, z_for_positions
    from shgan_torch.ops import conv1024
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

    out, ms = {}, {"pallas": [], "xla": []}
    try:
        for impl in ("pallas", "xla"):
            conv1024.set_conv1024_impl(impl)
            build.reset_launches()
            out[impl] = fwd().cpu().numpy().astype(np.int16)
            out[impl + "_k3"] = build.launches["conv3x3_lowch"]
        for impl in ("pallas", "xla", "xla", "pallas"):
            conv1024.set_conv1024_impl(impl)
            ms[impl].append(eager_ms(fwd, 3))
    finally:
        conv1024.set_conv1024_impl("xla")
    if out["pallas_k3"] != 2 or out["xla_k3"] != 0:
        raise AssertionError(f"K3 launches on/off: {out['pallas_k3']} / "
                             f"{out['xla_k3']}, expected 2 / 0")
    d = np.abs(out["pallas"] - out["xla"])
    row = {"phase": "k3_in_place", "model": MODEL_1024, "batch": EVAL_BATCH,
           "noise_mode": "const", "tf32": False,
           "within_1": float((d <= 1).mean()), "max_abs_diff": int(d.max()),
           "k3_launches_per_forward": out["pallas_k3"],
           "forward_ms_k3": ms["pallas"], "forward_ms_cudnn": ms["xla"]}
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


def train_sites(G, D):
    """(K2 calls of the encoder, of the synthesis and of D per forward,
    synthesis layers), read off the modules: each resampling conv is one K2
    call, each upsampling synthesis block's skip image one more."""
    def k2(module):
        n = 0
        for m in module.modules():
            name = type(m).__name__
            if name == "Conv2dLayer" and (m.up > 1 or m.down > 1):
                n += 1
            elif name == "SynthesisLayer" and m.up > 1:
                n += 1
            elif name == "CoModSynthesisBlock":
                n += 1   # upsample2d of the skip image
        return n
    layers = sum(type(m).__name__ == "SynthesisLayer" for m in G.modules())
    return k2(G.encoder), k2(G.synthesis), k2(D), layers


def expected_train_launches(n_enc, n_syn, n_d, layers, greg, dreg):
    """Kernel launches of one train step.  Gmain: G and D forwards, every
    K2 call and every epilogue differentiated once.  Gpl: a G forward at
    the shrunk batch; d img / d ws runs the synthesis' K2 calls backwards
    (n_syn) and the epilogues' grad kernel; the penalty's backward runs
    those backward calls' own backward (n_syn, K2 again), the encoder's
    (n_enc), and per epilogue the grad kernel once more plus its two
    mask-only launches.  Dmain: G under no_grad (the in-place epilogue), D
    on fakes and reals, each D call differentiated.  R1: D on reals, d D /
    d real (n_d), and that gradient's backward (2 n_d)."""
    n_g = n_enc + n_syn
    want = {"upfirdn2d": (n_g + n_d) + (n_g + 2 * n_d),
            "upfirdn2d_grad": (n_g + n_d) + 2 * n_d,
            "philox_normal": 0, "conv3x3_lowch": 0,
            "noise_bias_act": 2 * layers, "noise_bias_act_grad": layers}
    if greg:
        want["upfirdn2d"] += n_g
        want["upfirdn2d_grad"] += 2 * n_syn + n_enc
        want["noise_bias_act"] += layers
        want["noise_bias_act_grad"] += 4 * layers
    if dreg:
        want["upfirdn2d"] += n_d
        want["upfirdn2d_grad"] += 3 * n_d
    return want


def check_fir_grad(fir, calls):
    """K2's backward (and the backward of that, a K2 forward) at each of
    ``calls`` against autograd of fir_plain on the same inputs, float32;
    the backward call timed alone beside autograd of the plain version and
    the cuDNN call that computes the same gradient."""
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]), gain=1)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(77)
    for site, r, shape, up, down, pads, gain in calls:
        t = taps * gain
        ups, downs = (up, up), (down, down)
        x = torch.randn(shape, generator=gen, device="cuda")
        y_shape = fir.fir_plain(x[:1, :1], t, ups, downs, pads).shape[2:]
        dy = torch.randn((shape[0], shape[1]) + tuple(y_shape),
                         generator=gen, device="cuda")
        u = torch.randn(shape, generator=gen, device="cuda")
        outs = {}
        for name, fn in (("kernel", fir.fir), ("plain", fir.fir_plain)):
            xr = x.clone().requires_grad_(True)
            dyr = dy.clone().requires_grad_(True)
            y = fn(xr, t, ups, downs, pads)
            dx, = torch.autograd.grad(y, xr, dyr, create_graph=True)
            ddy, = torch.autograd.grad((dx * u).sum(), dyr)
            outs[name] = (dx.detach(), ddy, y, xr)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for a, b in zip(outs["kernel"][:2], outs["plain"][:2]))
        if not err <= FIR_F32_ATOL:
            raise AssertionError(f"K2 backward {site} R={r} {shape}: {err}")
        flipped = np.ascontiguousarray(t[::-1, ::-1])
        gp = fir.grad_pads(shape[2], shape[3], t, ups, downs, pads)
        bwd = lambda: fir.fir_cuda(dy, flipped, downs, ups, gp,  # noqa
                                   "upfirdn2d_grad")
        dx = outs["kernel"][0]
        nbytes = (dy.numel() + dx.numel()) * 4
        it = iters_for(nbytes)
        yp, xp = outs["plain"][2], outs["plain"][3]
        row = {"site": site, "res": r, "shape": list(shape), "up": up,
               "down": down, "pads": list(pads), "backward_up": down,
               "backward_down": up, "max_abs_err": err, "iters": it,
               "ms": graph_ms(bwd, nbytes), "eager_ms": eager_ms(bwd, it),
               "plain_ms": eager_ms(lambda: torch.autograd.grad(
                   yp, xp, dy, retain_graph=True), it)}
        c = shape[1]
        w = torch.as_tensor(np.array(t), device="cuda")[None, None].expand(
            c, 1, *t.shape).contiguous()
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
            lib_err = float((lib() - dx).abs().max())
            if not lib_err <= FIR_F32_ATOL:
                raise AssertionError(f"K2 backward yardstick {site}: "
                                     f"{lib_err}")
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
            lambda key, n, r, device="cpu":
            self.noise.philox_normal_cuda(key, n, r, device))

    def __exit__(self, *exc):
        self.nba.philox_normal_plain = self.orig


def check_epilogue_grad(noise, nba, cfg, batch, pl_batch):
    """The grad kernel at each synthesis layer shape of ``cfg``: its full
    mode at ``batch`` (the main phases' backward) against its plain
    version on the same noise, dx within 4 ulp and the sums within 1e-5 of
    the sum of their terms' magnitudes; its mask-only mode at ``pl_batch``
    (the path-length penalty's double backward) within 4 ulp; its
    regenerated noise against K1's bit for bit; timed beside the plain
    version and autograd of the PyTorch chain on the same inputs."""
    from shgan_torch.ops.bias_act import parse_activation
    spec = cfg["args"]["synthesis"]["args"].get(
        "activation", "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")
    act = nba.epilogue_act(parse_activation(spec))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(batch + 5)
    for (r, c), count in sorted(epilogue_layers(cfg).items()):
        key = noise.noise_key(4321, 2 * r)
        x = torch.randn((batch, c, r, r), generator=gen, device="cuda")
        dy = torch.randn((batch, c, r, r), generator=gen, device="cuda")
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
        ulp = 2.0 ** (torch.floor(torch.log2(want[0].abs().clamp_min(
            1e-30))) - 23)
        err = float((got[0] - want[0]).abs().max())
        if not bool(((got[0] - want[0]).abs() <= 4 * ulp).all()):
            raise AssertionError(f"grad kernel dx R={r} C={c}: {err}")
        sums_rel = 0.0
        for a, w_, mag in ((got[1], want[1], (g * x).abs().sum((2, 3))),
                           (got[2], want[2], g.abs().sum((0, 2, 3))),
                           (got[3], want[3], (g * nu).abs().sum())):
            rel = float(((a.double() - w_.double()).abs()
                         / (mag + 1e-30)).max())
            sums_rel = max(sums_rel, rel)
        if not sums_rel <= 1e-5:
            raise AssertionError(f"grad kernel sums R={r} C={c}: {sums_rel}")
        # the regenerated noise: mask-only, v = 0, vs = 1, linear, gain 1
        zero = torch.zeros((batch, c, r, r), device="cuda")
        nu_k = nba.noise_bias_act_mask_cuda(
            zero, zero, noise_mode="random", noise_key=key,
            strength=torch.ones((), device="cuda"),
            vs=torch.ones((), device="cuda"))
        if not torch.equal(nu_k, nu.expand_as(nu_k)):
            raise AssertionError(f"grad kernel's noise != K1 at R={r}")
        # mask-only at the path-length batch
        v = dy[:pl_batch].contiguous()
        kwp = dict(kw, dcoefs=d[:pl_batch].contiguous())
        m_got = nba.noise_bias_act_mask_cuda(v, x[:pl_batch].contiguous(),
                                             **kwp)
        with k1_noise_in_plain(nba, noise):
            m_want = nba.noise_bias_act_mask_plain(
                v, x[:pl_batch].contiguous(), **kwp)
        mu = 2.0 ** (torch.floor(torch.log2(m_want.abs().clamp_min(1e-30)))
                     - 23)
        if not bool(((m_got - m_want).abs() <= 4 * mu).all()):
            raise AssertionError(f"mask-only R={r}: "
                                 f"{float((m_got - m_want).abs().max())}")
        nbytes = 3 * x.numel() * 4 + (d.numel() + b.numel() + 1) * 4
        it = iters_for(nbytes)
        kern = lambda: nba.noise_bias_act_grad_cuda(dy, x, **kw)  # noqa
        xr, dr, br, sr = (t.clone().requires_grad_(True) for t in (x, d, b, s))
        yr = nba.noise_bias_act_plain(xr, dr, br, act, noise_mode="random",
                                      noise_key=key, strength=sr)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            yr, (xr, dr, br, sr), dy, retain_graph=True)
        row = {"res": r, "channels": c, "batch": batch,
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


def train_config(tmp, steps):
    """``shgan_ffhq256_train`` through the CLI's config assembly: the model
    as configured (``shgan_g256`` + ``comodgan_d256``, float32, batch 8),
    the dataset swapped to synthetic 256² (FFHQ is not on the machine),
    ``steps`` steps in two ticks, one snapshot at the end."""
    from shgan_torch.main import build_config
    nimg = steps * TRAIN_BATCH
    return build_config(
        TRAIN_EXPERIMENT, dataset="synthetic256_inpainting",
        log_root=os.path.join(tmp, "train"),
        overrides={"train.experiment_id": 0,
                   "train.total_kimg": nimg / 1000,
                   "train.kimg_per_tick": nimg / 2000,
                   "train.snapshot_ticks": 1000})


def params_of(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def max_diff(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def parity_grads(cfg, dev, seed=0, strength=0.1):
    """The G gradient of one Gmain and the D gradient of one Dmain + R1 at
    batch 2 on ``dev``, from weights drawn from ``seed`` with every bias
    moved by N(0, 0.1) (zero-initialised biases would put the SHU's ReLU
    kinks on the spectra's exact zeros, the imaginary DC and Nyquist bins,
    whose sign is each FFT library's rounding) and every noise_strength at
    ``strength``; the draws from CPU generators.  Returns ({leaf: grad on
    the CPU}, seconds)."""
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


def train_parity(cfg, seed=0):
    """One Gmain, Dmain and R1 gradient at batch 2 on the card and on the
    CPU (the plain versions), the same weights and draws, TF32 off, every
    noise_strength at its initial 0: each gradient leaf's difference within
    1e-3 of its norm, the PARITY_LOOSE leaves within 1e-2.  A second card
    run with cuDNN's autotuner on (other convolution algorithms, so other
    summation orders) gives each leaf's float32 spread on one device, for
    the record."""
    card, card_s = parity_grads(cfg, "cuda", seed, strength=0.0)
    cpu, cpu_s = parity_grads(cfg, "cpu", seed, strength=0.0)
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        card2, _ = parity_grads(cfg, "cuda", seed, strength=0.0)
    finally:
        torch.backends.cudnn.benchmark = prev
    rel = rel_errs(card, cpu)
    spread = dict((k, e) for e, k in rel_errs(card2, card))
    loose = [(e, k) for e, k in rel if any(t in k for t in PARITY_LOOSE)]
    tight = [(e, k) for e, k in rel if not any(t in k for t in PARITY_LOOSE)]
    row = {"phase": "train_parity", "batch": PARITY_BATCH, "tf32": False,
           "noise_strength": 0.0, "leaves": len(cpu),
           "worst_rel_err": tight[0][0], "worst_leaf": tight[0][1],
           "worst_5": [(e, k, spread[k]) for e, k in tight[:5]],
           "loose_leaves": len(loose),
           "loose_worst_5": [(e, k, spread[k]) for e, k in loose[:5]],
           "median_rel_err": rel[len(rel) // 2][0],
           "median_card_spread": sorted(spread.values())[len(spread) // 2],
           "cuda_s": card_s, "cpu_s": cpu_s}
    emit(row)
    if not (tight[0][0] <= PARITY_TOL and loose[0][0] <= PARITY_LOOSE_TOL):
        raise AssertionError(f"train card vs CPU: {tight[0]}, {loose[0]}")
    return row


def train_path(tmp, cli, build):
    """The training path as the CLI runs it (``main.run`` of the assembled
    config), fenced per phase, with launch counts per step; then the
    snapshot reloaded and one step from it against the same step from
    memory (cuDNN deterministic)."""
    from shgan_torch.checkpoint.train_state import load_train_state
    from shgan_torch.data.datasets import get_dataset
    from shgan_torch.data.formatters import get_formatter
    from shgan_torch.data.pipeline import TrainPipeline
    from shgan_torch.data.transforms import wrap_formatter
    from shgan_torch.models.registry import get_model
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    cfg = train_config(tmp, TRAIN_STEPS)
    # launches in each step, and outside the steps (before step 0, between
    # steps, after the last): the counts are set to 0 as each step starts
    # and read as it ends
    per_step, outside = [], []

    def on_step_start(i):
        outside.append(dict(build.launches))
        build.reset_launches()

    def on_step(i, metrics):
        per_step.append(dict(build.launches))
        build.reset_launches()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    os.environ["SHGAN_TRAIN_TIMING"] = "1"
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        rv = cli.run(cfg, on_step=on_step, on_step_start=on_step_start)
    finally:
        del os.environ["SHGAN_TRAIN_TIMING"]
    outside.append(dict(build.launches))
    stage_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step = rv["step"]
    tc = step.cfg
    sites = train_sites(step.G, step.D)
    for i, got in enumerate(per_step):
        want = expected_train_launches(*sites, i % tc.g_reg_interval == 0,
                                       i % tc.d_reg_interval == 0)
        if got != want:
            raise AssertionError(f"train step {i} launches {got}, "
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
               noise_bias_act=GRID_FORWARDS * sites[3])
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
    phases = timing["phase_s"]
    row = {"phase": "train_path", "experiment": TRAIN_EXPERIMENT,
           "model_g": cfg["model_g"].get("name"),
           "model_d": cfg["model_d"].get("name"),
           "dataset": cfg["train"]["dataset"]["name"], "batch": TRAIN_BATCH,
           "steps": TRAIN_STEPS, "regs": [
               ("G" if i % tc.g_reg_interval == 0 else "")
               + ("D" if i % tc.d_reg_interval == 0 else "")
               for i in range(TRAIN_STEPS)],
           "step_ms": [s * 1e3 for s in timing["step_s"]],
           "phase_ms": [{k: v * 1e3 for k, v in p.items()} for p in phases],
           "images_per_s_steps_1_5": TRAIN_BATCH * (TRAIN_STEPS - 1)
           / sum(timing["step_s"][1:]),
           "peak_mem_gib": peak_gib, "stage_s": stage_s,
           "launches_per_step": per_step,
           "launches_per_grid": fwd, "grids": grids,
           "stats_jsonl_keys": sorted(stats[0]), "sites": dict(zip(
               ("k2_encoder", "k2_synthesis", "k2_discriminator",
                "synthesis_layers"), sites)),
           "ticks": ticks, "pl_mean": float(step.pl_mean),
           "max_weight_move": moved, "fenced": True}
    emit(row)

    # the snapshot, reloaded; one step from it and from memory
    snap = os.path.join(cfg["train"]["log_dir"], "weight",
                        "network-snapshot-000000")
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
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
            st.timing = False
            st(real, mask, step_generator(0, st.step), 0.999, True, True)
            outs.append((params_of(st.G), params_of(st.D),
                         params_of(st.G_ema), float(st.pl_mean)))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev
    diffs = [max_diff(a, b) for a, b in zip(outs[0][:3], outs[1][:3])]
    resume = {"phase": "train_resume", "snapshot": os.path.basename(snap),
              "step": step.step, "max_abs_diff_G_D_Gema": diffs,
              "pl_mean": [outs[0][3], outs[1][3]]}
    emit(resume)
    if any(diffs) or outs[0][3] != outs[1][3]:
        raise AssertionError(f"resumed step differs: {resume}")
    del fresh, step, rv
    torch.cuda.empty_cache()
    return row, cfg


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
                       "library_eager_ms")},
          "max_abs_err": max(r["max_abs_err"] for r in epi_rows),
          "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in epi_rows),
          "noise_equals_k1": True})
    detail["noise_bias_act"] = epi_rows

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
                                     "bf16_bound_ms", "bf16_hbm_share")}})
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
                                     "library_ms", "library_eager_ms")}})
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
                      cpu_plain=False)
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

    per_fwd_fir = len(detail["fir_calls"][SERVE_BATCH])
    per_fwd_noise = sum(layers.values())
    # every synthesis layer's epilogue is one fused launch; K1 itself is
    # off the main path
    want_serve = {"upfirdn2d": 3 * per_fwd_fir, "upfirdn2d_grad": 0,
                  "philox_normal": 0, "conv3x3_lowch": 0,
                  "noise_bias_act": 3 * per_fwd_noise,
                  "noise_bias_act_grad": 0}
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
          "buckets": engine.buckets, "requests_rows": [8, 8, 3],
          "latency_ms": lat_ms, "images_per_s": n_img / (sum(lat_ms) / 1e3),
          "steady_images_per_s": 40 / steady_s, "launches": launches,
          "expected_per_forward": {k: v // 3 for k, v in want_serve.items()},
          "setup_s": setup_s, "cudnn_tf32": True,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "deterministic": True, "known_pixels_exact": True})

    # ---- 4. whole-path parity, card vs CPU ----------------------------------
    torch.backends.cudnn.allow_tf32 = False
    state = {k: v.cpu() for k, v in engine.G.state_dict().items()}
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
        n_batches = EVAL_IMAGES // EVAL_BATCH
        want = {"conv3x3_lowch": 2 * n_batches,
                "upfirdn2d": len(calls_1024) * n_batches,
                "upfirdn2d_grad": 0, "philox_normal": 0,
                "noise_bias_act": sum(layers_1024.values()) * n_batches,
                "noise_bias_act_grad": 0}
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

        # the same stage again with SHGAN_EVAL_TIMING=1, which fences each
        # generator forward to split each batch's time
        scfg = eval_config(tmp, g_pth, inc_pth, EVAL_IMAGES, "log_split")
        os.environ["SHGAN_EVAL_TIMING"] = "1"
        try:
            split = cli.run(scfg)["timing"]
        finally:
            del os.environ["SHGAN_EVAL_TIMING"]
        split_s = sum(split["batch_s"][1:]) + split["drain_s"]
        emit({"phase": "eval_path", "model": MODEL_1024,
              "experiment": "shgan_synthetic256_eval", "images": EVAL_IMAGES,
              "batch": EVAL_BATCH, "resolution": K3_RES,
              "noise_mode": "random", "pallas_conv1024": True,
              "cudnn_tf32": True, "metrics": metrics,
              "launches": eval_launches,
              "expected_per_forward": {k: v // n_batches
                                       for k, v in want.items()},
              "images_per_s": EVAL_BATCH * (n_batches - 1) / loop_s,
              "images_timed": EVAL_BATCH * (n_batches - 1),
              "batch_s": timing["batch_s"], "drain_s": timing["drain_s"],
              "fenced_images_per_s": EVAL_BATCH * (n_batches - 1) / split_s,
              "fenced_phase_mean_s": {
                  k: float(np.mean([p[k] for p in split["phase_s"][1:]]))
                  for k in ("pipe_wait_s", "gen_s", "metrics_s")},
              "fenced_gen_s": [p["gen_s"] for p in split["phase_s"]],
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
        train_launches = {k: sum(s[k] for s in train_row["launches_per_step"])
                          for k in train_row["launches_per_step"][0]}
        torch.backends.cudnn.allow_tf32 = False
        parity_row = train_parity(tcfg)
        detail.update(train_path=train_row, train_parity=parity_row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 9. the kernels line -------------------------------------------------
    detail.update(eval_launches=eval_launches, k3_in_place=in_place,
                  train_launches=train_launches)
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

    def resampling(prefix, rows, bf16=True):
        ms = sum(r["ms"] for r in rows)
        out = {f"{prefix}_ms": ms,
               f"{prefix}_bound_ms": sum(r["bound_ms"] for r in rows),
               f"{prefix}_hbm_share": sum(r["bytes_ms"] for r in rows) / ms,
               f"{prefix}_library_ms": sum(r["library_ms"] for r in rows)}
        if bf16:
            out[f"{prefix}_bf16_ms"] = sum(r["bf16_ms"] for r in rows)
        return out
    emit({"kernels": [
        {"name": "upfirdn2d", "route": "cuda",
         "source": "shgan_torch/csrc/upfirdn2d.cu",
         "replaces": "shgan_tpu/ops/fir_pallas.py:100",
         "replaces_function": "_pallas_fir",
         "launches": launches["upfirdn2d"],
         "launches_eval_path": eval_launches["upfirdn2d"],
         "launches_train_path": train_launches["upfirdn2d"],
         "max_abs_err": max(r["max_abs_err"] for r in fr + fir_1024),
         "ms": wsum(fr, "ms"), "eager_ms": wsum(fr, "eager_ms"),
         "bf16_ms": wsum(fr, "bf16_ms"),
         "plain_ms": wsum(fr, "plain_ms"),
         "bound_ms": wsum(fr, "bound_ms"), "bound_by": bound_by(fr),
         "library_ms": wsum(fr, "library_ms"),
         **resampling("d_skip", dsk), **resampling("img_upsample", ups),
         "scope": f"all {len(fr)} calls of one {MODEL} forward at batch "
                  f"{SERVE_BATCH}, float32 (bf16_ms: in bfloat16); "
                  f"d_skip_*: the {len(dsk)} 1x1 skips (down = 2) of one "
                  f"{TRAIN_D} forward at batch {TRAIN_BATCH}, library_ms "
                  "cuDNN's stride-2 depthwise conv2d; img_upsample_*: the "
                  f"{len(ups)} skip-image upsamples (up = 2) of the {MODEL} "
                  "forward, library_ms cuDNN's stride-2 conv_transpose2d; "
                  "launches over the serving path "
                  f"(and over the {MODEL_1024} eval path)"},
        {"name": "philox_normal", "route": "cuda",
         "source": "shgan_torch/csrc/noise.cu",
         "replaces": "shgan_tpu/ops/noise.py:68",
         "replaces_function": "_pallas_normal",
         "launches": launches["philox_normal"],
         "launches_eval_path": eval_launches["philox_normal"],
         "launches_train_path": train_launches["philox_normal"],
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
         "max_abs_err": max(r["max_abs_err"] for r in er + epi_1024),
         "ms": wsum(er, "ms"), "eager_ms": wsum(er, "eager_ms"),
         "bf16_ms": wsum(er, "bf16_ms"),
         "plain_ms": wsum(er, "plain_ms"),
         "bound_ms": wsum(er, "bound_ms"), "bound_by": bound_by(er),
         "hbm_share": wsum(er, "bytes_ms") / wsum(er, "ms"),
         "library_ms": wsum(er, "library_ms"),
         "library_eager_ms": wsum(er, "library_eager_ms"),
         "ms_1024": e1["ms"] * e1["layers_per_forward"],
         "bound_ms_1024": e1["bound_ms"] * e1["layers_per_forward"],
         "library_ms_1024": e1["library_ms"] * e1["layers_per_forward"],
         "scope": f"all {per_fwd_noise} synthesis layers of one {MODEL} "
                  f"forward at batch {SERVE_BATCH}, random noise, float32 "
                  "(bf16_ms: in bfloat16; *_1024: the 1024² layers of one "
                  f"{MODEL_1024} forward at batch {EVAL_BATCH}); "
                  "library_ms: the unfused path on the same inputs, K1 "
                  "plus the PyTorch chain (no single PyTorch call computes "
                  "the function); launches over the serving path (and over "
                  f"the {MODEL_1024} eval path)"},
        {"name": "conv3x3_lowch", "route": "cuda",
         "source": "shgan_torch/csrc/conv3x3_lowch.cu",
         "replaces": "shgan_tpu/ops/conv1024.py:101",
         "replaces_function": "conv3x3_lowch",
         "launches": eval_launches["conv3x3_lowch"],
         "launches_train_path": train_launches["conv3x3_lowch"],
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
         "ms": 2 * k3["ms"], "eager_ms": 2 * k3["eager_ms"],
         "plain_ms": 2 * k3["plain_ms"],
         "bound_ms": 2 * k3["bound_ms"], "bound_by": k3["bound_by"],
         "floor_3xtf32_ms": 2 * k3["floor_3xtf32_ms"],
         "library_ms": 2 * k3["library_ms"],
         "library_tf32_ms": 2 * k3["library_tf32_ms"],
         "bf16_ms": 2 * k3["bf16_ms"],
         "bf16_bound_ms": 2 * k3["bf16_bound_ms"],
         "bf16_library_ms": 2 * k3["bf16_library_ms"],
         "scope": f"both calls of one {MODEL_1024} forward at batch "
                  f"{EVAL_BATCH} ([{EVAL_BATCH},32,1024,1024] 32->32), "
                  "float32, TF32 off (library_tf32_ms: cuDNN with TF32; "
                  "bound: bytes or operations at the TF32 tensor-core rate; "
                  "floor_3xtf32_ms: three TF32 products a multiply-add; "
                  "bf16_*: in bfloat16); "
                  f"launches over the {MODEL_1024} eval path"},
        {"name": "upfirdn2d_backward", "route": "cuda",
         "source": "shgan_torch/csrc/upfirdn2d.cu",
         "replaces": "shgan_tpu/ops/fir_pallas.py:150",
         "replaces_function": "the custom VJP of _pallas_fir (_make_op's "
                              "bwd, XLA on the TPU)",
         "launches": train_launches["upfirdn2d_grad"],
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
         "scope": f"the backward of each of the {len(fgr)} K2 calls of one "
                  f"{g256['name']} forward and one {tcfg['model_d']['name']} "
                  f"forward at batch {TRAIN_BATCH}, float32 (kernel K2 on "
                  "the cotangent: reversed taps, up and down swapped); "
                  "plain_ms: autograd of fir_plain's backward; library_ms: "
                  "the cuDNN call computing the same gradient; resample_*: "
                  f"the {len(rsg)} backwards that resample (up = 2 or "
                  "down = 2); launches: "
                  f"K2's derivative calls over the {TRAIN_STEPS}-step train "
                  "path (backward and second order)"},
        {"name": "noise_bias_act_grad", "route": "cuda",
         "source": "shgan_torch/csrc/noise_bias_act.cu",
         "replaces": "shgan_tpu/ops/noise.py:68",
         "replaces_function": "JAX autodiff of the chain after "
                              "_pallas_normal (the noise has no gradient)",
         "launches": train_launches["noise_bias_act_grad"],
         "max_abs_err": max(r["max_abs_err"] for r in egr),
         "sums_max_rel_err": max(r["sums_max_rel_err"] for r in egr),
         "ms": wsum(egr, "ms"), "eager_ms": wsum(egr, "eager_ms"),
         "mask_ms": wsum(egr, "mask_ms"),
         "plain_ms": wsum(egr, "plain_ms"),
         "bound_ms": wsum(egr, "bound_ms"), "bound_by": bound_by(egr),
         "hbm_share": wsum(egr, "bytes_ms") / wsum(egr, "ms"),
         "library_ms": wsum(egr, "library_ms"),
         "scope": f"all {sum(r['layers_per_forward'] for r in egr)} "
                  f"synthesis layers of one {g256['name']} backward at batch "
                  f"{TRAIN_BATCH}, random noise, float32, the full mode "
                  f"(mask_ms: the mask-only mode at batch {TRAIN_BATCH // 2}"
                  "); library_ms: autograd of the PyTorch chain "
                  "(noise_bias_act_plain) on the same inputs, eager; "
                  f"launches over the {TRAIN_STEPS}-step train path"},
    ], "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
