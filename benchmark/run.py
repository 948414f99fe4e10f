#!/usr/bin/env python3
"""The benchmark of ``shgan_torch``: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

run from the root of a checkout that holds ``shgan_torch``.  The cell's
configuration, traffic mix, settings and per-layer metrics are files under
this directory, found by the names in ``BENCHMARK.json`` (see
``harness/runner.py``).  The run sets up (imports, kernel build or load,
weights made on the card from the seed, the input pool, warm-up of the
cell's shapes), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``, then ``checks`` (each number
compared, with its limit; also the last lines on standard error).

It exits with 2 and prints no result without a CUDA card (or with fewer
cards than the cell asks for), and with 3 if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))
# caches of the program's build tools stay inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)

from harness import runner  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = runner.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"run.py: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    have = runner.cuda_devices()
    if have < entry["chips"]:
        print(f"run.py: the cell needs {entry['chips']} CUDA card(s), "
              f"found {have}; not run", file=sys.stderr)
        return 2
    cell = runner.Cell(manifest, args.workload, args.seed, args.seconds,
                       args.trace, torch.device("cuda", 0), t_start=T_START)
    result = runner.execute(
        cell, device_fn=lambda: runner.device_info(entry["chips"]))
    bad = runner.forbidden_modules()
    if bad:
        print(f"run.py: loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
