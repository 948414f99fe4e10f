#!/usr/bin/env python3
"""Spatial (H) sharding across cards: ``chip_smoke.py`` phase 13's
comparison with one rank a card over NCCL.

Run from the repository root on a machine with that many CUDA cards:

    python3 chip_spatial_nccl.py [--cards 4] [--out perf_out]

The ranks form a mesh whose model axis is every card (``--cards`` model
ranks, one data rank), so the halo rows travel between cards through
NCCL's point-to-point.  :func:`chip_smoke.sp_sharded_vs_one` runs
``shgan_g1024``'s forward (batch 4, random weights and noise, K3 on, TF32
off, ``min_res`` 512) and three steps of ``shgan_ffhq256_train``'s
networks (global batch 8, ``min_res`` 64, step 0 with Gpl and R1) in this
process on ``cuda:0``, then on the ranks, and holds them to phase 13's
rules: the uint8 composites by phase 4's rule with the known pixels exact,
each rank's launches the one process's, step 0's gradients each network
within 1e-3 or 4× the median of its three float32 spread samples on one
card measured in the same run, the replicas bit for bit after every step,
and the ranks' step 0 with ``train.remat``'s networks held to their step 0
without it by the same gate.  Its times are one timed request and one
timed step each, not a steady rate.

Prints one JSON line (also written to ``<out>/spatial_nccl.json``); exits
non-zero if a rank fails or a check does not hold.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--out", default="perf_out")
    args = ap.parse_args()
    if args.cards < 2 or not torch.cuda.is_available() \
            or torch.cuda.device_count() < args.cards:
        print(f"needs {max(args.cards, 2)} CUDA cards", file=sys.stderr)
        return 1
    import chip_smoke
    from shgan_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _, build_s = build.build_all()
    with tempfile.TemporaryDirectory(prefix="spatial_nccl_") as work:
        row, _ = chip_smoke.sp_sharded_vs_one(work, args.cards, args.cards)
    if row["backend"] != "nccl":
        raise AssertionError(f"the ranks ran over {row['backend']}")
    row = {"nvidia_smi": smi.splitlines(), "kernel_build_s": build_s, **row}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "spatial_nccl.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
