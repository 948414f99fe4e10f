#!/usr/bin/env python3
"""Device time of a cell's traced window, by kernel name.

    python3 tools/trace_kernels.py --workload g512-stream-b8 [--seed N]
        [--seconds S] [--group other] [--out FILE]

Runs one traced window of a benchmark cell through the benchmark's own
harness (``benchmark/harness``: the same engine, traffic, profiler and
kernel grouping as ``benchmark/run.py --trace 1``) and prints, for each
kernel group of the ``breakdown``, its device seconds, and for the groups
named by ``--group`` (comma-separated, ``all`` for every group) each kernel
name in it with its device seconds and launch count.  The full table goes
to ``--out`` as JSON.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))


def by_name(kernels):
    """{name: [seconds, launches]} of the trace's device events."""
    out = {}
    for a, b, n in kernels:
        s = out.setdefault(n, [0.0, 0])
        s[0] += (b - a) / 1e6
        s[1] += 1
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="g512-stream-b8")
    ap.add_argument("--seed", type=int, default=2101)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--group", default="other")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_kernels: no CUDA device", file=sys.stderr)
        return 2
    from harness import runner, trace
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "bench_cache" / "torch_ext"))
    manifest = runner.load_json(ROOT / "BENCHMARK.json")
    cell = runner.Cell(manifest, args.workload, args.seed, args.seconds, 1,
                       torch.device("cuda", 0))
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = False
    if cell.settings.get("host_threads"):
        torch.set_num_threads(int(cell.settings["host_threads"]))
    driver = runner.load_module(cell.driver_path, "driver").Driver(
        cell, lambda s: print(s, file=sys.stderr, flush=True))
    driver.setup()
    out = driver.window(True)
    driver.release()
    tr = out["trace"]
    names = by_name(tr.kernels)
    groups = {}
    for n, (s, k) in names.items():
        g = groups.setdefault(trace.group_of(n), {"seconds": 0.0,
                                                   "kernels": {}})
        g["seconds"] += s
        g["kernels"][n] = {"seconds": s, "launches": k}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    batches = len(out["facts"]["batches"])
    result = {"workload": args.workload, "seed": args.seed, "card": smi,
              "window_s": tr.window_s, "busy_s": tr.busy_s,
              "batches": batches, "groups": groups}
    want = set(groups) if args.group == "all" else set(args.group.split(","))
    print(smi)
    print(f"window {tr.window_s:.3f} s, busy {tr.busy_s:.3f} s, "
          f"{batches} batches")
    for g, v in sorted(groups.items(), key=lambda kv: -kv[1]["seconds"]):
        print(f"{v['seconds']:9.4f} s  {g}")
        if g in want:
            for n, r in sorted(v["kernels"].items(),
                               key=lambda kv: -kv[1]["seconds"]):
                print(f"    {r['seconds']:9.4f} s  {r['launches']:7d}  "
                      f"{n[:150]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
