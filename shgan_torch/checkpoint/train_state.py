"""Training snapshots (counterpart of ``shgan_tpu/checkpoint/orbax_io.py``).

A snapshot is a directory ``weight/network-snapshot-<kimg>/`` holding

  * ``state.pt``: the whole training state (G, D, G_ema, both optimizers,
    ``pl_mean``, ``step``), written with ``torch.save``;
  * ``G_ema.pth``: G_ema's state_dict alone, the file the port's eval stage
    loads with its strict key check (``eval.pretrained_pth``).

Both are written to a temporary name and renamed, so a run killed during a
save leaves the previous snapshot whole.
"""

from __future__ import annotations

import os
import os.path as osp

import torch

STATE_FILE = "state.pt"
G_EMA_FILE = "G_ema.pth"


def _cpu(sd):
    return {k: v.detach().cpu() if torch.is_tensor(v) else v
            for k, v in sd.items()}


def _atomic_save(obj, path):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_state(path, step):
    """Write the snapshot directory ``path`` of a :class:`~..train.TrainStep`
    ``step``."""
    os.makedirs(path, exist_ok=True)
    g_ema = _cpu(step.G_ema.state_dict())
    _atomic_save({"G": _cpu(step.G.state_dict()),
                  "D": _cpu(step.D.state_dict()),
                  "G_ema": g_ema,
                  "opt_g": step.opt_g.state_dict(),
                  "opt_d": step.opt_d.state_dict(),
                  "pl_mean": float(step.pl_mean),
                  "step": int(step.step)}, osp.join(path, STATE_FILE))
    _atomic_save(g_ema, osp.join(path, G_EMA_FILE))


def load_train_state(path, step):
    """Restore the snapshot directory (or its ``state.pt``) ``path`` into
    ``step`` in place, on the device its models live on."""
    if osp.isdir(path):
        path = osp.join(path, STATE_FILE)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    step.G.load_state_dict(sd["G"], strict=True)
    step.D.load_state_dict(sd["D"], strict=True)
    step.G_ema.load_state_dict(sd["G_ema"], strict=True)
    step.opt_g.load_state_dict(sd["opt_g"])
    step.opt_d.load_state_dict(sd["opt_d"])
    step.pl_mean = torch.tensor(sd["pl_mean"], dtype=torch.float32,
                                device=step.pl_mean.device)
    step.step = int(sd["step"])
    return step
