#!/usr/bin/env python3
"""Time K2's resampling kernel built with other launch bounds, at the 1x1
skips of ``comodgan_d256`` (down = 2) and their backward (up = 2), batch 8,
float32 and bf16, on one NVIDIA GPU.

    python3 tools/k2_bounds_bench.py [--bounds ours,none,3] [--out FILE]

Each variant is this checkout's ``shgan_torch/csrc/upfirdn2d.cu`` with the
``__launch_bounds__`` of ``upfirdn2d_resample_kernel`` replaced: ``ours``
as committed, ``none`` without a minimum of blocks an SM (the compiler's
own register count), an integer N that minimum for every tile.  Each is
built with the package's nvcc flags into its own library under
``build/k2_bounds/`` and called through its C entry point; the variants
take turns (in order, then reversed) on each call, timed by
``chip_smoke.graph_ms`` and checked against ``fir_plain``.  Prints the
card's ``nvidia-smi`` name and power limit, then a line a call: each
variant's two times (ms) and its best share of the HBM rate.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BOUNDS = re.compile(
    r"__launch_bounds__\([^\n]*\)(\s*upfirdn2d_resample_kernel)")


def build_variant(build, name):
    """Start nvcc on the variant ``name``; returns (process, library)."""
    csrc = os.path.join(ROOT, "shgan_torch", "csrc")
    out = os.path.join(ROOT, "build", "k2_bounds", name)
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(csrc, "upfirdn2d.cuh"), out)
    src = open(os.path.join(csrc, "upfirdn2d.cu")).read()
    if name != "ours":
        arg = "" if name == "none" else f", {int(name)}"
        src, n = BOUNDS.subn(rf"__launch_bounds__(shgan::kFirThreads{arg})\1",
                             src)
        if n != 1:
            raise RuntimeError("upfirdn2d_resample_kernel's launch bounds "
                               "not found")
    with open(os.path.join(out, "upfirdn2d.cu"), "w") as f:
        f.write(src)
    so = os.path.join(out, "libupfirdn2d.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", so,
           os.path.join(out, "upfirdn2d.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bounds", default="ours,none,3",
                    help="variants: ours, none, or a minimum of blocks")
    ap.add_argument("--out", default=None, help="file for the times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_bounds_bench: no CUDA device", file=sys.stderr)
        return 2
    cs = importlib.import_module("chip_smoke")
    from shgan_torch.kernels import build
    from shgan_torch.runtime.config import model_cfg_bank
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    names = args.bounds.split(",")
    procs = {n: build_variant(build, n) for n in names}
    fns = {}
    for n, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc, variant {n}:\n{log}")
        fn = ctypes.CDLL(so).shgan_upfirdn2d
        fn.argtypes = list(build.ENTRY_POINTS["upfirdn2d"]["shgan_upfirdn2d"])
        fn.restype = ctypes.c_int
        fns[n] = fn

    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]))
    flipped = np.ascontiguousarray(taps[::-1, ::-1])
    calls = []
    for site, _r, shape, up, down, pads, _g in cs.train_fir_calls(
            model_cfg_bank()(cs.TRAIN_G), model_cfg_bank()(cs.TRAIN_D),
            cs.TRAIN_BATCH):
        if site != "d_skip_down":
            continue
        n, c, h, w = shape
        calls.append(("down", shape, taps, (1, 1), (2, 2), pads))
        gp = fir.grad_pads(h, w, taps, (1, 1), (2, 2), pads)
        oh = fir.out_size(h, 1, 2, pads[2], pads[3], 4)
        ow = fir.out_size(w, 1, 2, pads[0], pads[1], 4)
        calls.append(("up", (n, c, oh, ow), flipped, (2, 2), (1, 1), gp))
    rows = []
    for kind, shape, t, up, down, pads in calls:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device="cuda").to(dt)
            n, c, h, w = shape
            oh = fir.out_size(h, up[1], down[1], pads[2], pads[3], 4)
            ow = fir.out_size(w, up[0], down[0], pads[0], pads[1], 4)
            y = torch.empty((n, c, oh, ow), device="cuda", dtype=dt)
            want = fir.fir_plain(x.float(), t, up, down, pads)
            tol = 1e-5 if dt == torch.float32 else cs.bf16_ulp(want) + 1e-6
            tp = t.ctypes.data_as(ctypes.c_void_p)

            def call(fn):
                return fn(x.data_ptr(), y.data_ptr(),
                          0 if dt == torch.float32 else 1, n * c, h, w, oh,
                          ow, up[0], up[1], down[0], down[1], pads[0],
                          pads[2], tp, 4, 4, 0,   # NCHW
                          torch.cuda.current_stream().cuda_stream)
            nbytes = (x.numel() + y.numel()) * x.element_size()
            row = {"kind": kind, "shape": list(shape),
                   "dtype": str(dt).split(".")[1], "ms": {}}
            for name in names + names[::-1]:
                build.check(call(fns[name]), f"variant {name}")
                torch.cuda.synchronize()
                if not bool(((y.float() - want).abs() <= tol).all()):
                    raise AssertionError(f"variant {name}: {row}")
                row["ms"].setdefault(name, []).append(
                    cs.graph_ms(lambda: call(fns[name]), nbytes))
            row["hbm_share"] = {
                k: nbytes / cs.HBM_BYTES_PER_S * 1e3 / min(v)
                for k, v in row["ms"].items()}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
