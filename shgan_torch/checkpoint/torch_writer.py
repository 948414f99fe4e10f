"""Write a ``.pth`` state_dict file (port of
``shgan_tpu/checkpoint/torch_writer.py``): what the reference's eval stage,
the JAX package's reader and the port's strict load all take."""

from __future__ import annotations

import numpy as np
import torch


def _flat(tree, prefix=""):
    """Nested ``{name: dict | array}`` → flat ``{"a.b.c": leaf}`` in the
    JAX package's ``params_to_flat_state_dict`` key order (depth first, in
    insertion order)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def save_torch_pth(path, params):
    """Write ``params`` (a flat ``{name: tensor | array}`` state_dict, or a
    nested tree of them) to ``path`` as float32 CPU tensors; 0-d leaves
    stay 0-d (a ``noise_strength`` of shape (1,) would fail a strict shape
    check on load)."""
    sd = {}
    for k, v in _flat(params).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        sd[k] = torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
    torch.save(sd, path)
    return path
