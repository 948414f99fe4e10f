"""Where the card's and the CPU's training gradients part (the port,
``shgan_torch``, on a CUDA card).

``chip_smoke.py`` phase 8 (``train_parity``) holds one Gmain + Dmain + R1
gradient of ``shgan_ffhq256_train``'s networks at batch 2 on the card
against the CPU.  This script takes that gradient apart:

* the same gradient on the card under cuDNN's deterministic, default and
  autotuned algorithms (twice each where a mode may be nondeterministic),
  with cuDNN off (PyTorch's own CUDA convolutions), with the port's kernels
  replaced by their plain versions on the card, and with the encoder run
  on the CPU inside the card's step; each against the CPU run: the worst
  leaf, the worst noise_strength / SHU leaf, the encoder's median leaf and
  every noise_strength leaf;
* each 3×3 and 1×1 convolution shape of ``shgan_g256``'s encoder at batch
  2, forward, input gradient and weight gradient, on the CPU in float32
  and on the card in each cuDNN mode, against float64 on the CPU.

One JSON line per run and per shape; everything also in
``<out>/parity_trace.json``.  Needs a CUDA card and the repository
(``python3 chip_parity_trace.py [--out perf_out]``, ~4 min on an
H100, kernel build included).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

import torch
import torch.nn as nn
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402


class no_cudnn:
    def __enter__(self):
        self.prev = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False

    def __exit__(self, *exc):
        torch.backends.cudnn.enabled = self.prev


class plain_on_card:
    """The port's kernel wrappers run their plain versions on CUDA
    tensors."""

    def __init__(self, fir, nba):
        self.fir, self.nba = fir, nba

    def __enter__(self):
        fir, nba = self.fir, self.nba
        self.orig = (fir.fir_cuda, nba.noise_bias_act_cuda,
                     nba.noise_bias_act_grad_cuda,
                     nba.noise_bias_act_mask_cuda)

        def fir_cuda(x, taps, up=(1, 1), down=(1, 1), pads=(0, 0, 0, 0),
                     counter=None):
            return fir.fir_plain(x, taps, up, down, pads)

        def epilogue(x, out=None, **kw):
            y = nba.noise_bias_act_plain(x, **kw)
            return y if out is None else out.copy_(y)
        fir.fir_cuda, nba.noise_bias_act_cuda = fir_cuda, epilogue
        nba.noise_bias_act_grad_cuda = nba.noise_bias_act_grad_plain
        nba.noise_bias_act_mask_cuda = nba.noise_bias_act_mask_plain

    def __exit__(self, *exc):
        (self.fir.fir_cuda, self.nba.noise_bias_act_cuda,
         self.nba.noise_bias_act_grad_cuda,
         self.nba.noise_bias_act_mask_cuda) = self.orig


def tree_map(f, x):
    if torch.is_tensor(x):
        return f(x)
    if isinstance(x, dict):
        return {k: tree_map(f, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(f, v) for v in x)
    return x


class OnCPU(nn.Module):
    """``module`` run on the CPU inside a step on the card (its parameter
    names gain ``.m``)."""

    def __init__(self, module):
        super().__init__()
        self.m = module.cpu()

    def forward(self, *args, **kwargs):
        out = self.m(*tree_map(lambda t: t.cpu(), args),
                     **tree_map(lambda t: t.cpu(), kwargs))
        return tree_map(lambda t: t.cuda(), out)


def encoder_on_cpu(G, D):
    G.encoder = OnCPU(G.encoder)
    return G, D


def step_grads(cfg, dev, patch=None, seed=0):
    """``chip_smoke.parity_grads``'s gradient (noise strengths at 0), with
    ``patch(G, D)`` applied to the models on ``dev``."""
    grads = cs.parity_grads(cfg, dev, seed, strength=0.0, patch=patch)[0]
    return {k.replace(".m.", "."): v for k, v in grads.items()}


def summary(got, ref):
    rel = cs.rel_errs(got, ref)
    tight = [r for r in rel if not cs.is_loose(r[1])]
    loose = [r for r in rel if cs.is_loose(r[1])]
    enc = sorted(e for e, k in rel if k.startswith("G.encoder.b"))
    return {"worst": tight[0], "worst_loose": loose[0],
            "encoder_median": enc[len(enc) // 2],
            "median": rel[len(rel) // 2][0],
            "noise_strength": {k: e for e, k in rel
                               if k.endswith("noise_strength")}}


ENCODER_CONVS = [  # (in, out, res, kernel, stride) of shgan_g256's encoder
    (64, 64, 256, 3, 1), (64, 128, 128, 3, 2), (128, 128, 128, 3, 1),
    (256, 256, 64, 3, 1), (512, 512, 32, 3, 1), (512, 512, 16, 3, 1),
    (512, 512, 8, 3, 1), (512, 512, 4, 3, 1), (4, 64, 256, 1, 1)]


def conv_errors(modes):
    """Each encoder conv's forward, input and weight gradient on each
    ``(name, device, context)`` of ``modes`` against float64 on the CPU:
    ``|got - ref| / |ref|`` of each."""
    rows = []
    for c, o, res, k, stride in ENCODER_CONVS:
        g = torch.Generator().manual_seed(c + res)
        side = res + (1 if stride == 2 else 0)
        x = torch.randn(2, c, side, side, generator=g, dtype=torch.float64)
        w = torch.randn(o, c, k, k, generator=g,
                        dtype=torch.float64) / (c * k * k) ** 0.5
        pad = k // 2 if stride == 1 else 0
        dy = torch.randn(F.conv2d(x, w, stride=stride, padding=pad).shape,
                         generator=g, dtype=torch.float64)

        def run(dev, dtype):
            xx = x.to(dev, dtype).requires_grad_(True)
            ww = w.to(dev, dtype).requires_grad_(True)
            y = F.conv2d(xx, ww, stride=stride, padding=pad)
            gx, gw = torch.autograd.grad(y, (xx, ww), dy.to(dev, dtype))
            return [t.detach().double().cpu() for t in (y, gx, gw)]
        ref = run("cpu", torch.float64)
        row = {"conv": [c, o, res, k, stride]}
        for name, dev, ctx in modes:
            with ctx():
                got = run(dev, torch.float32)
            row[name] = [float((a - b).norm() / b.norm())
                         for a, b in zip(got, ref)]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="perf_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_parity_trace: needs a CUDA card", file=sys.stderr)
        return 2
    from shgan_torch.kernels import build
    from shgan_torch.ops import noise_bias_act as nba
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    cfg = cs.train_config(tempfile.mkdtemp(), cs.TRAIN_STEPS)
    none = cs.cudnn_flags     # PyTorch's default: both flags off
    det = lambda: cs.cudnn_flags(deterministic=True)  # noqa: E731
    bench = lambda: cs.cudnn_flags(benchmark=True)  # noqa: E731
    runs = [("cudnn_deterministic", det, None),
            ("cudnn_deterministic_again", det, None),
            ("cudnn_default", none, None),
            ("cudnn_default_again", none, None),
            ("cudnn_autotuner", bench, None),
            ("cudnn_off", no_cudnn, None),
            ("port_kernels_plain", lambda: plain_on_card(fir, nba), None),
            ("encoder_on_cpu", det, encoder_on_cpu)]
    t0 = time.perf_counter()
    cpu = step_grads(cfg, "cpu")
    out = {"card": smi, "cpu_s": time.perf_counter() - t0, "runs": {}}
    for name, ctx, patch in runs:
        with ctx():
            got = step_grads(cfg, "cuda", patch)
        out["runs"][name] = summary(got, cpu)
        print(json.dumps({name: out["runs"][name]}), flush=True)
    out["convs"] = conv_errors([
        ("cpu_float32", "cpu", none), ("card_cudnn_default", "cuda", none),
        ("card_cudnn_deterministic", "cuda", det),
        ("card_cudnn_autotuner", "cuda", bench),
        ("card_cudnn_off", "cuda", no_cudnn)])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "parity_trace.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
