#!/usr/bin/env python3
"""Time kernels K2 (upfirdn2d), K3 (conv3x3_lowch) and the fused synthesis
epilogue (noise_bias_act) on one NVIDIA GPU at the shapes of the port's
main path, each checked against its plain version.

    python3 tools/kernel_bench.py [--root DIR]
        [--only k2,k3,width,nba,bl,resample,k2grad,nhwc] [--out FILE]

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
fused kernel skips it); the conv layers' epilogue (``bl``: bias_lrelu) at
every encoder conv of a ``shgan_g512`` and a ``shgan_g1024`` forward at
batch 8, beside the PyTorch chain it replaced (a checkout without it skips
it); K2's resampling calls (``resample``): the 1x1 skips
of ``comodgan_d256`` at batch 8 (down = 2) and their backward (up = 2), the
skip-image upsample of ``shgan_g256`` at batch 8 (up = 2) and its backward
(down = 2), float32 and bf16, each beside the one cuDNN call that computes
it (``conv2d`` with stride 2, ``conv_transpose2d`` with stride 2); the
backward of every K2 call of one ``shgan_g256`` and one ``comodgan_d256``
forward at batch 8 (``k2grad``, chip_smoke.py's ``check_fir_grad``); every
forward kernel of a ``shgan_g512`` and a ``shgan_g1024`` forward at batch 8
(``nhwc``: K2's stride-1 and resampling calls, the synthesis epilogues,
``bias_lrelu`` at the encoder convs, K3 at 1024²) on NCHW and, where the
checkout's kernels take it, on channels-last tensors (their NHWC maps),
with the byte bound and whether both layouts give the same bits.  Prints
the card's ``nvidia-smi`` name and power limit, then one JSON line; the
full rows go to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
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


def resample_calls(bank, batch):
    """(site, input shape, up, down, pads, gain) of K2's resampling calls on
    the training path: D's 1x1 skips (down = 2, pads 1) and their backward
    (up = 2 on the skips' outputs, pads (2, 1)); the skip-image upsample
    (up = 2, gain 4) and its backward (down = 2, taps times 4)."""
    d = bank("comodgan_d256")["args"]
    g = bank("shgan_g256")["args"]["synthesis"]["args"]
    calls, r = [], int(d["resolution"])
    while r > 4:
        c = min(int(d["ch_base"]) // r, int(d["ch_max"]))
        calls.append(("d_skip_down", (batch, c, r, r), 1, 2, (1, 1, 1, 1), 1))
        calls.append(("d_skip_down_bwd", (batch, c, r // 2, r // 2), 2, 1,
                      (2, 1, 2, 1), 1))
        r //= 2
    r = 8
    while r <= int(g["resolution"]):
        calls.append(("img_upsample", (batch, 3, r // 2, r // 2), 2, 1,
                      (2, 1, 2, 1), 4))
        calls.append(("img_upsample_bwd", (batch, 3, r, r), 1, 2,
                      (1, 1, 1, 1), 4))
        r *= 2
    return calls


def resample_rows(cs, fir, calls):
    """Each call: K2 against fir_plain (float32 1e-5; bf16 one bf16 ulp +
    1e-6), K2's and the cuDNN call's CUDA-graph ms, the byte bound and the
    share of the HBM rate, float32 and bf16."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]))
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for site, shape, up, down, pads, gain in calls:
        t = taps * gain
        f, d = (up, up), (down, down)
        x = torch.randn(shape, generator=gen, device="cuda")
        c = shape[1]
        w = torch.as_tensor(np.array(t), device="cuda")[None, None].expand(
            c, 1, 4, 4).contiguous()
        row = {"site": site, "shape": list(shape), "up": up, "down": down,
               "pads": list(pads)}
        for name, xx in (("f32", x), ("bf16", x.bfloat16())):
            y = fir.fir_cuda(xx, t, f, d, pads)
            want = fir.fir_plain(xx.float(), t, f, d, pads)
            err = (y.float() - want).abs()
            tol = (1e-5 if name == "f32"
                   else cs.bf16_ulp(want) + 1e-6)
            if not bool((err <= tol).all()):
                raise AssertionError(f"K2 {name} {site} {shape}: "
                                     f"{float(err.max())}")
            ww = w.to(xx.dtype)
            if down == 2:   # pads (1, 1): a stride-2 depthwise conv2d
                lib = lambda xx=xx, ww=ww: F.conv2d(  # noqa: E731
                    xx, ww, stride=2, padding=1, groups=c)
            else:   # zero-insert + pads (2, 1): a stride-2 transposed conv
                wt = ww.flip([2, 3]).contiguous()
                lib = lambda xx=xx, wt=wt: F.conv_transpose2d(  # noqa: E731
                    xx, wt, stride=2, padding=1, groups=c)
            lib_err = float((lib().float() - want).abs().max())
            nbytes = (xx.numel() + y.numel()) * xx.element_size()
            ms = cs.graph_ms(lambda xx=xx: fir.fir_cuda(xx, t, f, d, pads),
                             nbytes)
            bytes_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
            row[name] = {"max_abs_err": float(err.max()), "ms": ms,
                         "bound_ms": bytes_ms, "hbm_share": bytes_ms / ms,
                         "library_ms": cs.graph_ms(lib, nbytes),
                         "library_max_abs_err": lib_err}
        rows.append(row)
        del x
        torch.cuda.empty_cache()
    return rows


def nhwc_rows(cs, model, batch, dtype):
    """One ``model`` forward's kernel calls at ``batch`` in ``dtype``: each
    call's CUDA-graph ms on NCHW and (where the kernels take it) on a
    channels-last tensor, its bound (bytes over the HBM rate; K3: the larger
    of that and its operations at the rate of its arithmetic, 3xTF32 in
    float32) and whether the two layouts gave the same bits."""
    import torch
    from shgan_torch.ops import conv1024
    from shgan_torch.ops import noise_bias_act as nba
    from shgan_torch.ops.bias_act import parse_activation
    from shgan_torch.runtime.config import model_cfg_bank
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
    try:
        importlib.import_module("shgan_torch.ops.layout")
        both = True
    except ImportError:   # a checkout before the NHWC maps
        both = False
    cfg = model_cfg_bank()(model)
    syn = cfg["args"]["synthesis"]["args"]
    ch = lambda r: min(int(syn["ch_base"]) // r, int(syn["ch_max"]))  # noqa
    act = nba.epilogue_act(parse_activation(
        "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"))
    g = torch.Generator(device="cuda").manual_seed(9)
    key = torch.tensor([0x1234567, 0x89ABCDE, 0], dtype=torch.int64,
                       device="cuda")
    size = torch.tensor([], dtype=dtype).element_size()
    calls = []
    for site, r, shape, up, down, pads, gain in cs.fir_calls(cfg, batch):
        t = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]), gain=gain)
        oh = fir.out_size(shape[2], up, down, pads[2], pads[3], 4)
        ow = fir.out_size(shape[3], up, down, pads[0], pads[1], 4)
        calls.append((
            "k2_stride1" if up == down == 1 else "k2_resample", site, shape,
            lambda x, t=t, up=up, down=down, pads=pads: fir.fir(
                x, t, (up, up), (down, down), pads),
            (shape[0] * shape[1] * (shape[2] * shape[3] + oh * ow)) * size,
            0))
    for r, k in cs.noise_layers(cfg).items():
        shape = (batch, ch(r), r, r)
        d = torch.rand(batch, ch(r), generator=g, device="cuda") + 0.5
        b = torch.randn(ch(r), generator=g, device="cuda") * 0.1
        s = torch.full((), 0.3, device="cuda")
        for _ in range(k):
            calls.append(("epilogue", f"syn{r}", shape,
                          lambda x, d=d, b=b, s=s: nba.noise_bias_act(
                              x, d, b, act, noise_mode="random",
                              noise_key=key, strength=s),
                          2 * math.prod(shape) * size, 0))
    for (r, c), k in cs.encoder_conv_layers(cfg).items():
        b = torch.randn(c, generator=g, device="cuda") * 0.1
        for _ in range(k):
            shape = (batch, c, r, r)
            calls.append(("bias_lrelu", f"enc{r}", shape,
                          lambda x, b=b: nba.noise_bias_act(x, None, b, act),
                          2 * math.prod(shape) * size, 0))
    if int(syn["resolution"]) >= conv1024.MIN_RES:
        w = torch.randn(32, 32, 3, 3, generator=g, device="cuda") / 17
        shape = (batch, 32, conv1024.MIN_RES, conv1024.MIN_RES)
        ops = 2 * 9 * 32 * math.prod(shape) * (3 if size == 4 else 1)
        for _ in range(2):
            calls.append(("k3", "syn1024", shape,
                          lambda x, w=w: conv1024.conv3x3_lowch(x, w),
                          2 * math.prod(shape) * size, ops))
    rows = []
    rate = cs.TF32_FLOPS_PER_S if size == 4 else cs.BF16_FLOPS_PER_S
    with torch.inference_mode():
        for kernel, site, shape, fn, nbytes, ops in calls:
            x = (torch.randn(shape, generator=g, device="cuda") * 2).to(dtype)
            row = {"kernel": kernel, "site": site, "shape": list(shape),
                   "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S,
                                   ops / rate) * 1e3,
                   "nchw_ms": cs.graph_ms(lambda: fn(x), nbytes)}
            if both:
                xl = x.contiguous(memory_format=torch.channels_last)
                a, b = fn(x.clone()), fn(xl.clone())
                row["same_bits"] = bool(torch.equal(
                    a.contiguous().view(torch.int16), b.contiguous().view(
                        torch.int16)))
                row["nhwc_ms"] = cs.graph_ms(lambda: fn(xl), nbytes)
            rows.append(row)
            del x
            torch.cuda.empty_cache()
    return rows


def nhwc_summary(rows):
    """Sums by kernel: NCHW and NHWC ms, bound ms and share of the bound,
    and whether every call gave the same bits on both maps."""
    out = {}
    for k in sorted({r["kernel"] for r in rows}):
        sub = [r for r in rows if r["kernel"] == k]
        o = {"calls": len(sub), "bound_ms": sum(r["bound_ms"] for r in sub),
             "nchw_ms": sum(r["nchw_ms"] for r in sub)}
        o["nchw_share"] = o["bound_ms"] / o["nchw_ms"]
        if all("nhwc_ms" in r for r in sub):
            o["nhwc_ms"] = sum(r["nhwc_ms"] for r in sub)
            o["nhwc_share"] = o["bound_ms"] / o["nhwc_ms"]
            o["same_bits"] = all(r["same_bits"] for r in sub)
        out[k] = o
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose shgan_torch and chip_smoke.py run")
    ap.add_argument("--only", default="k2,k3,width,nba,bl,resample,k2grad",
                    help="k2, k3, width (K2 at an odd and an even output "
                         "width, beside PyTorch's streaming kernels), nba "
                         "(the fused synthesis epilogue), bl (bias_lrelu, "
                         "the encoder's conv epilogues), resample (K2's "
                         "down = 2 / up = 2 calls of training) and/or "
                         "k2grad (K2's backward over one G and D forward); "
                         "nhwc (every forward kernel of a shgan_g512 and a "
                         "shgan_g1024 forward at batch 8, NCHW beside NHWC)")
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
    if "bl" in only and hasattr(cs, "check_conv_epilogue"):
        from shgan_torch.ops import noise_bias_act as nba
        for name, model in (("bl_g512", cs.MODEL), ("bl_g1024",
                                                     cs.MODEL_1024)):
            rows = cs.check_conv_epilogue(nba, model_cfg_bank()(model),
                                          cs.SERVE_BATCH)
            full[name] = rows
            w = [r["layers_per_forward"] for r in rows]
            out[name] = {
                k: sum(r[k] * n for r, n in zip(rows, w))
                for k in ("ms", "eager_ms", "bf16_ms", "bound_ms",
                          "bytes_ms", "library_ms", "library_eager_ms")}
            out[name]["hbm_share"] = out[name]["bytes_ms"] / out[name]["ms"]
            out[name]["layers"] = [
                {k: r[k] for k in ("res", "channels", "layers_per_forward",
                                   "ms", "bound_ms", "hbm_share", "bf16_ms",
                                   "library_ms")} for r in rows]
    if "resample" in only:
        rows = resample_rows(cs, fir, resample_calls(model_cfg_bank(), 8))
        full["resample"] = rows
        out["resample"] = {
            f"{k}_{dt}": sum(r[dt][k] for r in rows)
            for k in ("ms", "bound_ms", "library_ms") for dt in ("f32",
                                                                 "bf16")}
        for site in sorted({r["site"] for r in rows}):
            sub = [r for r in rows if r["site"] == site]
            out["resample"][site] = {
                dt: {k: [r[dt][k] for r in sub]
                     for k in ("ms", "bound_ms", "hbm_share", "library_ms")}
                for dt in ("f32", "bf16")}
            out["resample"][site]["shape"] = [r["shape"] for r in sub]
    if "k2grad" in only and hasattr(cs, "check_fir_grad"):
        bank = model_cfg_bank()
        rows = cs.check_fir_grad(fir, cs.train_fir_calls(
            bank("shgan_g256"), bank("comodgan_d256"), 8))
        full["k2grad"] = rows
        ms = sum(r["ms"] for r in rows)
        out["k2grad"] = {
            "ms": ms, "bound_ms": sum(r["bound_ms"] for r in rows),
            "hbm_share": sum(r["bytes_ms"] for r in rows) / ms,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "by_site": {site: sum(r["ms"] for r in rows
                                  if r["site"] == site)
                        for site in sorted({r["site"] for r in rows})}}
    if "k3" in only:
        full["k3"] = cs.check_conv3(conv1024, conv_resample)
        keys = ("shape", "flip_weight", "max_abs_err", "ms", "bound_ms",
                "bound_by", "floor_3xtf32_ms", "library_ms",
                "library_tf32_ms", "bf16_max_abs_err", "bf16_ms",
                "bf16_bound_ms", "bf16_library_ms")
        out["k3"] = [{k: r[k] for k in keys if k in r} for r in full["k3"]]
    if "nhwc" in only:
        for model in (cs.MODEL, cs.MODEL_1024):
            for dt in (torch.float32, torch.bfloat16):
                name = f"nhwc_{model}_{str(dt).split('.')[-1]}"
                full[name] = nhwc_rows(cs, model, cs.SERVE_BATCH, dt)
                out[name] = nhwc_summary(full[name])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**out, "rows": full}, f, indent=1, default=str)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
