"""Export one network of a training snapshot as a ``.pth`` state_dict
(the counterpart of the JAX package's ``tools/export_pth.py``)::

    python -m shgan_torch.export_pth \\
        --snapshot log/.../weight/network-snapshot-best \\
        --out shgan_ffhq256_ours.pth [--key G_ema|G|D]

``--snapshot``: a port snapshot directory or its ``state.pt``, or a
reference ``network-snapshot-*.pkl``.  ``--key`` also takes the JAX
package's names (``params_gema``, ``params_g``, ``params_d``).  The file
loads strictly into the port's eval stage (``--pretrained``), into the JAX
package and into the reference's.  Legacy TF pickles are refused: their
names need the remap of a warm start, which is no export.
"""

from __future__ import annotations

import argparse
import os.path as osp

import torch

from .checkpoint.snapshot import load_network_snapshot
from .checkpoint.torch_writer import save_torch_pth
from .checkpoint.train_state import STATE_FILE

NETWORKS = ("G_ema", "G", "D")
KEY_ALIASES = {"params_gema": "G_ema", "params_g": "G", "params_d": "D"}


def load_snapshot_network(snapshot, key="G_ema"):
    """The flat state_dict of network ``key`` of ``snapshot``."""
    key = KEY_ALIASES.get(key, key)
    if snapshot.endswith(".pkl"):
        data, is_tf = load_network_snapshot(snapshot)
        if is_tf:
            raise SystemExit("legacy TF pickles are load-only: warm-start "
                             "from them with --pretrained instead")
    else:
        path = (osp.join(snapshot, STATE_FILE) if osp.isdir(snapshot)
                else snapshot)
        data = torch.load(path, map_location="cpu", weights_only=True)
    nets = [k for k in NETWORKS if data.get(k) is not None]
    if key not in nets:
        raise SystemExit(f"--key {key!r} not in snapshot; available: "
                         f"{nets}")
    return data[key]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m shgan_torch.export_pth",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--snapshot", required=True,
                   help="snapshot directory, its state.pt, or a reference "
                        ".pkl")
    p.add_argument("--out", required=True, help="the .pth to write")
    p.add_argument("--key", default="G_ema",
                   help="G_ema / G / D (or params_gema / params_g / "
                        "params_d)")
    args = p.parse_args(argv)
    sd = load_snapshot_network(args.snapshot, args.key)
    save_torch_pth(args.out, sd)
    print(f"wrote {args.out} ({len(sd)} tensors from "
          f"{KEY_ALIASES.get(args.key, args.key)})")
    return args.out


if __name__ == "__main__":
    main()
