#!/usr/bin/env python3
"""Where the time of one shgan_torch serving request, or of one training
step, goes, on one CUDA card.

Serving: builds ``InpaintEngine(<model>, device="cuda", batch_size=<batch>)``
with random weights and random noise (every ``noise_strength`` 0.1),
answers one request to warm up, then answers ``--reps`` more under
``torch.profiler`` (CPU and CUDA activities).

Training (``--train``): builds the ``shgan_ffhq256_train`` models
(``shgan_g256`` + ``comodgan_d256``, random weights from seed 0) and the
port's ``TrainStep``, runs one step of each kind to warm up, then ``--reps``
steps with the regularizers ``--regs`` asks for (none, ``g`` for the
path-length penalty, ``d`` for R1, ``gd`` for both) under the profiler, on
a random batch of ``--batch`` 256² images.

Prints one JSON object: the request's (or step's) wall time, the device's
busy time and idle share over the profiled window, the device time by
kernel group and by the top kernels, and the device operations (kernels and
copies) per request or step.  Run from the repository root:

    python3 tools/profile_torch_serve.py [--model shgan_g512] [--batch 8]
        [--reps 3] [--k3] [--root DIR] [--out perf_out]
    python3 tools/profile_torch_serve.py --train [--regs gd] [--batch 8]

``--k3`` routes the 1024² convs to kernel K3, as the eval stage does;
``--root`` profiles the ``shgan_torch`` of another checkout (say an earlier
commit unpacked into a directory), so two versions are profiled by the same
tool in one run on one card.
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


def train_window(args):
    """(the profiled callable, a label) for ``--train``: ``--reps`` train
    steps with the regularizers of ``--regs``, after one warm-up step of
    each kind."""
    from shgan_torch.models.registry import get_model
    from shgan_torch.runtime.config import experiment_cfg_bank
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    cfg = experiment_cfg_bank()("shgan_ffhq256_train")
    G = get_model(cfg["model_g"], seed=0).cuda()
    D = get_model(cfg["model_d"], seed=1).cuda()
    step = TrainStep(G, D, TrainConfig(**cfg["train"]["loss_kwargs"]))
    g = torch.Generator().manual_seed(0)
    res = G.synthesis.resolution
    real = (torch.rand(args.batch, 3, res, res, generator=g) * 2 - 1).cuda()
    mask = (torch.rand(args.batch, 1, res, res, generator=g) > 0.5).float()
    mask = mask.cuda()
    greg, dreg = "g" in args.regs, "d" in args.regs
    for i, (a, b) in enumerate([(True, True), (greg, dreg)]):
        step(real, mask, step_generator(0, i), 0.999, a, b)

    def window():
        for i in range(args.reps):
            step(real, mask, step_generator(0, 2 + i), 0.999, greg, dreg)
    return window, f"train_{args.regs or 'main'}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile training steps of shgan_ffhq256_train")
    ap.add_argument("--regs", default="", choices=("", "g", "d", "gd"),
                    help="--train: the steps' regularizers")
    ap.add_argument("--model", default="shgan_g512")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--k3", action="store_true",
                    help="route the 1024² convs to kernel K3")
    ap.add_argument("--root", default=None,
                    help="checkout whose shgan_torch is profiled")
    ap.add_argument("--out", default="perf_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    from torch.profiler import ProfilerActivity, profile
    import shgan_torch
    from shgan_torch.ops import conv1024
    from shgan_torch.serve import InpaintEngine
    if args.k3:
        conv1024.set_conv1024_impl("pallas")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.train:
        window, label = train_window(args)
    else:
        engine = InpaintEngine(args.model, device="cuda",
                               batch_size=args.batch, noise_mode="random",
                               seed=0)
        with torch.no_grad():
            for name, p in engine.G.named_parameters():
                if name.endswith("noise_strength"):
                    p.fill_(0.1)
        res = engine.G.img_resolution
        rng = np.random.RandomState(0)
        imgs = rng.randint(0, 256, (args.batch, 3, res, res), dtype=np.uint8)
        masks = (rng.rand(args.batch, res, res) > 0.5).astype(np.float32)
        engine.inpaint(imgs, masks)

        def window():
            for i in range(args.reps):
                engine.inpaint(imgs, masks, start_index=args.batch * i)
        label = args.model
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = {}, 0
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            ops += evt.count
    busy_ms = sum(kernels.values()) / 1e3
    groups = {}
    for k, us in kernels.items():
        g = group_of(k)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / args.reps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    per = "step" if args.train else "request"
    result = {
        "card": smi, "model": label, "batch": args.batch,
        "reps": args.reps, "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "package": os.path.dirname(os.path.abspath(shgan_torch.__file__)),
        "k3": conv1024.conv1024_impl() == "pallas",
        f"{per}_wall_ms": wall_ms / args.reps,
        f"device_busy_ms_per_{per}": busy_ms / args.reps,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "images_per_s": args.batch * args.reps / (wall_ms / 1e3),
        f"device_ops_per_{per}": ops / args.reps,
        f"group_ms_per_{per}": dict(sorted(groups.items(),
                                           key=lambda kv: -kv[1])),
        f"top_kernels_ms_per_{per}": [(k[:120], us / 1e3 / args.reps)
                                      for k, us in top],
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_{label}_b{args.batch}"
                           ".json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
