#!/usr/bin/env python3
"""Drive the PyTorch port (shgan_torch) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py [--out perf_out]

Phases, each printing one JSON line:

1. card: the card's name and power limit (``nvidia-smi``), the kernels'
   build time (both built from ``shgan_torch/csrc`` in parallel);
2. kernels: kernel K2 (upfirdn2d) at every FIR call of a ``shgan_g512``
   forward and kernel K1 (Philox noise) at every noise resolution, at the
   serving batch (8) and at batch 4, in float32 (and bfloat16 for K2),
   held against their plain PyTorch versions on the same inputs with TF32
   off; kernel, plain, library-yardstick and CPU-plain times, and each
   call's least time on the card;
3. main path: ``InpaintEngine("shgan_g512", device="cuda", batch_size=8)``
   with random noise (every ``noise_strength`` set to 0.1 so the noise
   reaches the image) answers requests of 8, 8 and 3 rows; launch counts of
   both kernels over exactly those requests; the composite contract and
   run-to-run determinism; latency and images/s;
4. parity: the same weights with constant noise at batch 1 on the card and
   on the CPU (the plain versions), uint8 composites compared;
5. the kernels line ``{"kernels": [...]}``;
6. last line: ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero and prints no
result line.  It needs the repository (``shgan_torch``, ``configs/``) and
imports nothing of JAX.  Per-call details go to ``<out>/chip_smoke_detail.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

MODEL = "shgan_g512"
SERVE_BATCH = 8
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
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


def bound(row, nbytes, ops):
    """The least time for the call: its bytes over the memory rate or its
    operations over the float32 rate, whichever is larger."""
    row["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["ops_ms"] = ops / FP32_FLOPS_PER_S * 1e3
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                       else "operations")


def bound_by(rows):
    by = {r["bound_by"] for r in rows}
    return by.pop() if len(by) == 1 else "bytes and operations"


def bf16_ulp(v):
    return 2.0 ** (torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def check_fir(fir, batch, dtype_list, detail):
    """K2 against its plain version at every FIR call of one forward."""
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]), gain=1)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(batch)
    for site, r, shape, up, pads, gain in detail["fir_calls"][batch]:
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
        rows.append(row)
    return rows


def check_noise(noise, batch, layers):
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
               "library_eager_ms": eager_ms(lib, it),
               "plain_cpu_ms": cpu_ms(lambda: noise.philox_normal_plain(
                   key, batch, r, "cpu"))}
        # per 4 normals: 10 rounds of 2 mul-hi/lo + 4 xor + 2 key adds;
        # 2 x (log, sqrt, sincos, ~8 float ops) -> ~160 operations
        bound(row, 4 * n, n / 4 * 160)
        rows.append(row)
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
    from shgan_torch.ops import noise
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
    build.library("noise")
    build.library("upfirdn2d")
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
        fir_rows[b] = check_fir(fir, b, (torch.float32, torch.bfloat16),
                                detail)
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

    # ---- 3. the main path ------------------------------------------------
    # PyTorch's defaults for serving: cuDNN may use TF32 for float32 convs
    torch.backends.cudnn.allow_tf32 = True
    res = int(cfg["args"]["synthesis"]["args"]["resolution"])
    t0 = time.perf_counter()
    engine = InpaintEngine(MODEL, device="cuda", batch_size=SERVE_BATCH,
                           noise_mode="random", seed=0, latency_batches=(4,))
    with torch.no_grad():
        for name, p in engine.G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
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
    if launches["upfirdn2d"] != 3 * per_fwd_fir or \
            launches["philox_normal"] != 3 * per_fwd_noise:
        raise AssertionError(f"launch counts {launches}, expected "
                             f"{3 * per_fwd_fir} / {3 * per_fwd_noise}")
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
          "expected_per_forward": {"upfirdn2d": per_fwd_fir,
                                   "philox_normal": per_fwd_noise},
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

    # ---- 5. the kernels line -------------------------------------------------
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke_detail.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    fr, nr = fir_rows[SERVE_BATCH], noise_rows[SERVE_BATCH]
    wsum = lambda rows, k: sum(r[k] * r.get("layers_per_forward", 1)  # noqa
                               for r in rows)
    emit({"kernels": [
        {"name": "upfirdn2d", "route": "cuda",
         "source": "shgan_torch/csrc/upfirdn2d.cu",
         "replaces": "shgan_tpu/ops/fir_pallas.py:100",
         "replaces_function": "_pallas_fir",
         "launches": launches["upfirdn2d"],
         "max_abs_err": max(r["max_abs_err"] for r in fr),
         "ms": wsum(fr, "ms"), "eager_ms": wsum(fr, "eager_ms"),
         "plain_ms": wsum(fr, "plain_ms"),
         "bound_ms": wsum(fr, "bound_ms"), "bound_by": bound_by(fr),
         "library_ms": wsum(fr, "library_ms"),
         "scope": f"all {len(fr)} calls of one {MODEL} forward at batch "
                  f"{SERVE_BATCH}, float32"},
        {"name": "philox_normal", "route": "cuda",
         "source": "shgan_torch/csrc/noise.cu",
         "replaces": "shgan_tpu/ops/noise.py:68",
         "replaces_function": "_pallas_normal",
         "launches": launches["philox_normal"],
         "max_abs_err": max(r["max_abs_err"] for r in nr),
         "ms": wsum(nr, "ms"), "eager_ms": wsum(nr, "eager_ms"),
         "plain_ms": wsum(nr, "plain_ms"),
         "bound_ms": wsum(nr, "bound_ms"), "bound_by": bound_by(nr),
         "library_ms": wsum(nr, "library_ms"),
         "scope": f"all {per_fwd_noise} noise layers of one {MODEL} forward "
                  f"at batch {SERVE_BATCH}"},
    ], "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
