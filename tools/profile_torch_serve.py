#!/usr/bin/env python3
"""Where the time of one shgan_torch serving request goes, on one CUDA card.

Builds ``InpaintEngine(<model>, device="cuda", batch_size=<batch>)`` with
random weights and random noise (every ``noise_strength`` 0.1), answers one
request to warm up, then answers ``--reps`` more under ``torch.profiler``
(CPU and CUDA activities).  Prints one JSON object: the request's wall
time, the device's busy time and idle share over the profiled window, and
the device time by kernel group and by the top kernels.  Run from the
repository root:

    python3 tools/profile_torch_serve.py [--model shgan_g512] [--batch 8]
        [--reps 3] [--out perf_out]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("upfirdn2d (K2)", ("upfirdn2d",)),
    ("philox_normal (K1)", ("philox_normal",)),
    ("convolution", ("conv", "xmma", "implicit", "gemm", "cutlass", "sm90",
                     "sm80", "winograd", "dgrad", "fprop")),
    ("fft", ("fft", "regular_fft", "vector_fft")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "cat")),
)


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="shgan_g512")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="perf_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from shgan_torch.serve import InpaintEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    engine = InpaintEngine(args.model, device="cuda", batch_size=args.batch,
                           noise_mode="random", seed=0)
    with torch.no_grad():
        for name, p in engine.G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    res = engine.G.img_resolution
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (args.batch, 3, res, res), dtype=np.uint8)
    masks = (rng.rand(args.batch, res, res) > 0.5).astype(np.float32)
    engine.inpaint(imgs, masks)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.reps):
            engine.inpaint(imgs, masks, start_index=args.batch * i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    busy_ms = sum(kernels.values()) / 1e3
    groups = {}
    for k, us in kernels.items():
        g = group_of(k)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / args.reps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    result = {
        "card": smi, "model": args.model, "batch": args.batch,
        "reps": args.reps, "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "request_wall_ms": wall_ms / args.reps,
        "device_busy_ms_per_request": busy_ms / args.reps,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "images_per_s": args.batch * args.reps / (wall_ms / 1e3),
        "group_ms_per_request": dict(sorted(groups.items(),
                                            key=lambda kv: -kv[1])),
        "top_kernels_ms_per_request": [(k[:120], us / 1e3 / args.reps)
                                       for k, us in top],
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_{args.model}_b{args.batch}"
                           ".json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
