#!/usr/bin/env python3
"""One rank, other than rank 0, of a cell driven by ``train_dp.py``:

    python3 benchmark/traffic/train_dp_rank.py --manifest <json>
        --root <benchmark dir> --workload <cell> --seed <n> --seconds <s>
        --rank <r> --data <dir of the PNGs> --device cuda|cpu

with torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK`` in its environment (rank 0 sets them; the rest of it,
the build tools' cache directories among it, is rank 0's).  It sets the
configuration's precision and the cell's ``host_threads`` as
``harness/runner.execute`` does for rank 0, then runs ``Driver``'s set-up,
window and release on ``cuda:<rank>`` (or the CPU) and exits 0; at an error
it exits 1.  Rank 0 decides when the window ends; this rank reports in the
release whether it loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from harness import runner  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name in ("--manifest", "--root", "--workload", "--data", "--device"):
        ap.add_argument(name, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    dev = (torch.device("cuda", args.rank) if args.device == "cuda"
           else torch.device(args.device))
    cell = runner.Cell(runner.load_json(args.manifest), args.workload,
                       args.seed, args.seconds, 0, dev, root=args.root,
                       t_start=T_START)
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = False
    if cell.settings.get("host_threads"):
        torch.set_num_threads(int(cell.settings["host_threads"]))

    def log(s):
        print(s, file=sys.stderr, flush=True)

    driver = runner.load_module(cell.driver_path,
                                "driver_" + cell.traffic["driver"]).Driver(
        cell, log, rank=args.rank, data=args.data)
    driver.setup()
    driver.window(False)
    driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
