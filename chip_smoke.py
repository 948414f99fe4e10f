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
   PyTorch chain) on the same inputs;
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
8. the kernels line ``{"kernels": [...]}``;
9. last line: ``{"ok": true, "device": {...}}``.

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


def emit(obj):
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
    resolution, input shape, up, pads, gain).  Taps are [1,3,3,1]."""
    enc, syn = cfg["args"]["encoder"]["args"], cfg["args"]["synthesis"]["args"]
    res = int(enc["resolution"])
    ch = lambda base, r: min(int(base) // r, int(enc["ch_max"]))  # noqa: E731
    calls = []
    r = res
    while r > 4:   # encoder conv1 (down=2): blur with pad 2, then stride 2
        calls.append(("enc_down_blur", r, (batch, ch(enc["ch_base"], r), r, r),
                      1, (2, 2, 2, 2), 1))
        r //= 2
    r = 8
    while r <= res:
        c = min(int(syn["ch_base"]) // r, int(syn["ch_max"]))
        # synthesis conv0 (up=2): transposed conv to R+1, FIR with pad 1
        calls.append(("syn_up_fir", r, (batch, c, r + 1, r + 1), 1,
                      (1, 1, 1, 1), 4))
        # skip-image upsample2d: up=2, pads (2, 1)
        calls.append(("img_upsample", r, (batch, 3, r // 2, r // 2), 2,
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
    rows)."""
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]), gain=1)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(calls[0][2][0])
    for site, r, shape, up, pads, gain in calls:
        t = taps * gain
        x = torch.randn(shape, generator=gen, device="cuda")
        ups, downs = (up, up), (1, 1)
        y = fir.fir_cuda(x, t, ups, downs, pads)
        want = fir.fir_plain(x, t, ups, downs, pads)
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        if not err <= FIR_F32_ATOL:
            raise AssertionError(f"K2 f32 {site} R={r} {shape}: {err}")
        row = {"site": site, "res": r, "shape": list(shape), "up": up,
               "pads": list(pads), "max_abs_err": err,
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
        if up == 1:
            lib = lambda: F.conv2d(x, w, padding=pads[0], groups=c)  # noqa
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
    detail.update(fir_1024=fir_1024, noise_1024=noise_1024,
                  noise_bias_act_1024=epi_1024, conv3x3_lowch=conv_rows)

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
    want_serve = {"upfirdn2d": 3 * per_fwd_fir, "philox_normal": 0,
                  "conv3x3_lowch": 0, "noise_bias_act": 3 * per_fwd_noise}
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
                "philox_normal": 0,
                "noise_bias_act": sum(layers_1024.values()) * n_batches}
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 8. the kernels line -------------------------------------------------
    detail.update(eval_launches=eval_launches, k3_in_place=in_place)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke_detail.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    fr, nr = fir_rows[SERVE_BATCH], noise_rows[SERVE_BATCH]
    er, e1 = epi_rows, epi_1024[0]
    wsum = lambda rows, k: sum(r[k] * r.get("layers_per_forward", 1)  # noqa
                               for r in rows)
    k3 = conv_rows[0]   # [EVAL_BATCH, 32, 1024, 1024], float32
    emit({"kernels": [
        {"name": "upfirdn2d", "route": "cuda",
         "source": "shgan_torch/csrc/upfirdn2d.cu",
         "replaces": "shgan_tpu/ops/fir_pallas.py:100",
         "replaces_function": "_pallas_fir",
         "launches": launches["upfirdn2d"],
         "launches_eval_path": eval_launches["upfirdn2d"],
         "max_abs_err": max(r["max_abs_err"] for r in fr + fir_1024),
         "ms": wsum(fr, "ms"), "eager_ms": wsum(fr, "eager_ms"),
         "bf16_ms": wsum(fr, "bf16_ms"),
         "plain_ms": wsum(fr, "plain_ms"),
         "bound_ms": wsum(fr, "bound_ms"), "bound_by": bound_by(fr),
         "library_ms": wsum(fr, "library_ms"),
         "scope": f"all {len(fr)} calls of one {MODEL} forward at batch "
                  f"{SERVE_BATCH}, float32 (bf16_ms: in bfloat16); "
                  "launches over the serving path "
                  f"(and over the {MODEL_1024} eval path)"},
        {"name": "philox_normal", "route": "cuda",
         "source": "shgan_torch/csrc/noise.cu",
         "replaces": "shgan_tpu/ops/noise.py:68",
         "replaces_function": "_pallas_normal",
         "launches": launches["philox_normal"],
         "launches_eval_path": eval_launches["philox_normal"],
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
    ], "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0

if __name__ == "__main__":
    sys.exit(main())
