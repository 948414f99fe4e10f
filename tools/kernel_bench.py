#!/usr/bin/env python3
"""Time kernels K2 (upfirdn2d), K3 (conv3x3_lowch) and the fused synthesis
epilogue (noise_bias_act) on one NVIDIA GPU at the shapes of the port's
main path, each checked against its plain version.

    python3 tools/kernel_bench.py [--root DIR] [--only k2,k3,width,nba]
        [--out FILE]

It runs the kernel checks of ``chip_smoke.py`` phase 2 (the same inputs,
tolerances, CUDA-graph timing and bounds) from the checkout at ``--root``
(default: this one), so two versions of the kernels can be timed in one run
on one card: unpack another commit into a directory and pass it as
``--root``.  K2: every FIR call of a ``shgan_g512`` forward at batch 8 and
the 1024² calls of a ``shgan_g1024`` forward at batch 4, float32 and bf16;
K3: [4|1, 32, 1024²] 32→32, float32 and bf16, with cuDNN beside it; K2 at
[4, 32, 1024²] with a 1025- and a 1024-wide output beside PyTorch's own
streaming kernels (multiply, copy, pad to 1025) at that shape; the fused
epilogue at every synthesis layer of a ``shgan_g512`` forward at batch 8
and the 1024² layers of ``shgan_g1024`` at batch 4, beside the unfused
path on the same inputs (K1 plus the PyTorch chain; a checkout without the
fused kernel skips it).  Prints
the card's ``nvidia-smi`` name and power limit, then one JSON line; the
full rows go to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k2_summary(rows):
    """Per call: kernel ms, byte bound, share of the HBM rate; and sums."""
    calls = [{"site": r["site"], "res": r["res"], "shape": r["shape"],
              "ms": r["ms"], "bound_ms": r["bound_ms"],
              "hbm_share": r["bytes_ms"] / r["ms"],
              "bf16_ms": r.get("bf16_ms"),
              "bf16_hbm_share": (r["bf16_bound_ms"] / r["bf16_ms"]
                                 if "bf16_ms" in r else None),
              "max_abs_err": r["max_abs_err"],
              "bf16_max_abs_err": r.get("bf16_max_abs_err")}
             for r in rows]
    return {"sum_ms": sum(r["ms"] for r in rows),
            "sum_bf16_ms": sum(r.get("bf16_ms", 0.0) for r in rows),
            "sum_bound_ms": sum(r["bound_ms"] for r in rows),
            "calls": calls}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose shgan_torch and chip_smoke.py run")
    ap.add_argument("--only", default="k2,k3,width,nba",
                    help="k2, k3, width (K2 at an odd and an even output "
                         "width, beside PyTorch's streaming kernels) and/or "
                         "nba (the fused synthesis epilogue)")
    ap.add_argument("--out", default=None, help="file for the full rows")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    cs = importlib.import_module("chip_smoke")
    if not os.path.abspath(cs.__file__).startswith(root):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}")
    from shgan_torch.kernels import build
    from shgan_torch.ops import conv1024, conv_resample
    from shgan_torch.runtime.config import model_cfg_bank
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _, build_s = build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    only = set(args.only.split(","))
    out = {"root": root, "card": smi, "build_s": build_s}
    full = {}
    if "k2" in only:
        calls = cs.fir_calls(model_cfg_bank()(cs.MODEL), cs.SERVE_BATCH)
        full["k2_g512"] = cs.check_fir(fir, calls, (torch.float32,
                                                    torch.bfloat16),
                                       cpu_plain=False)
        calls = [c for c in cs.fir_calls(model_cfg_bank()(cs.MODEL_1024),
                                         cs.EVAL_BATCH) if c[1] == cs.K3_RES]
        full["k2_g1024"] = cs.check_fir(fir, calls, (torch.float32,
                                                     torch.bfloat16),
                                        cpu_plain=False)
        out["k2_g512_batch8"] = k2_summary(full["k2_g512"])
        out["k2_g1024_batch4"] = k2_summary(full["k2_g1024"])
    if "width" in only:
        # the same K2 call at [4, 32, 1024²] with an odd and an even output
        # width, and what PyTorch's own streaming kernels reach at the shape
        import torch.nn.functional as F
        taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]))
        x = torch.randn((4, 32, 1024, 1024), device="cuda")
        y = torch.empty_like(x)
        n_in = x.numel()
        cases = [(f"k2_out_{1024 + p[0] + p[1] - 3}",
                  lambda p=p: fir.fir_cuda(x, taps, (1, 1), (1, 1), p),
                  n_in + 128 * (1024 + p[0] + p[1] - 3) ** 2)
                 for p in ((2, 2, 2, 2), (2, 1, 2, 1))]
        cases += [("torch_mul", lambda: torch.mul(x, 2.0, out=y), 2 * n_in),
                  ("torch_copy", lambda: y.copy_(x), 2 * n_in),
                  ("torch_pad_to_1025", lambda: F.pad(x, (1, 0, 1, 0)),
                   n_in + 128 * 1025 ** 2)]
        out["width"] = {}
        for name, fn, elems in cases:
            ms = cs.graph_ms(fn, elems * 4)
            out["width"][name] = {
                "ms": ms,
                "hbm_share": elems * 4 / cs.HBM_BYTES_PER_S * 1e3 / ms}
    if "nba" in only and hasattr(cs, "check_epilogue"):
        from shgan_torch.ops import noise
        from shgan_torch.ops import noise_bias_act as nba
        cfg = model_cfg_bank()(cs.MODEL)
        full["nba_g512"] = cs.check_epilogue(noise, nba, cfg, cs.SERVE_BATCH)
        cfg = model_cfg_bank()(cs.MODEL_1024)
        layers = {k: v for k, v in cs.epilogue_layers(cfg).items()
                  if k[0] == cs.K3_RES}
        full["nba_g1024"] = cs.check_epilogue(noise, nba, cfg, cs.EVAL_BATCH,
                                              layers)
        for name in ("nba_g512", "nba_g1024"):
            rows = full[name]
            w = [r["layers_per_forward"] for r in rows]
            out[name] = {
                k: sum(r[k] * n for r, n in zip(rows, w))
                for k in ("ms", "eager_ms", "bf16_ms", "bound_ms",
                          "bytes_ms", "library_ms", "library_eager_ms")}
            out[name]["hbm_share"] = out[name]["bytes_ms"] / out[name]["ms"]
            out[name]["layers"] = [
                {k: r[k] for k in ("res", "channels", "layers_per_forward",
                                   "ms", "bound_ms", "hbm_share", "bf16_ms",
                                   "library_ms", "max_abs_err")}
                for r in rows]
    if "k3" in only:
        full["k3"] = cs.check_conv3(conv1024, conv_resample)
        keys = ("shape", "flip_weight", "max_abs_err", "ms", "bound_ms",
                "bound_by", "floor_3xtf32_ms", "library_ms",
                "library_tf32_ms", "bf16_max_abs_err", "bf16_ms",
                "bf16_bound_ms", "bf16_library_ms")
        out["k3"] = [{k: r[k] for k in keys if k in r} for r in full["k3"]]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**out, "rows": full}, f, indent=1, default=str)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
