"""Replica consistency across ranks (port of
``shgan_tpu/parallel/consistency.py``).

Every rank holds a full copy of the weights and updates it with the same
averaged gradients, so the copies stay equal bit for bit; after host-side
surgery (a snapshot load, a manual copy) a skewed copy is still possible.
This check broadcasts rank 0's values and compares each rank's with them.
"""

from __future__ import annotations

import torch

from . import multihost
from .mesh import create_mesh


def _named(obj, prefix=""):
    """(name, tensor) pairs of a module (parameters and buffers), a dict, a
    list or tuple of those, or a tensor."""
    if isinstance(obj, torch.nn.Module):
        yield from ((prefix + k, v) for k, v in obj.named_parameters())
        yield from ((prefix + k, v) for k, v in obj.named_buffers())
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _named(v, f"{prefix}{i}.")
    elif isinstance(obj, torch.Tensor):
        yield prefix.rstrip("."), obj


@torch.no_grad()
def check_replicated(tree, atol=0.0, max_report=5, mesh=None):
    """Raise unless every tensor of ``tree`` (modules, dicts, lists,
    tensors) equals rank 0's within ``atol`` (0: bit for bit, NaN equal to
    NaN) on every rank.  Rank 0's values are broadcast in one flat buffer
    per (dtype, device); every rank learns which names differed anywhere
    and raises the same ``AssertionError`` naming the first
    ``max_report``.  Returns the number of tensors checked."""
    leaves = list(_named(tree))
    if (mesh.world if mesh is not None else multihost.world_size()) == 1:
        return len(leaves)
    mesh = mesh or create_mesh()
    groups = {}
    for i, (_, t) in enumerate(leaves):
        groups.setdefault((t.dtype, t.device), []).append(i)
    flags = [0.0] * len(leaves)
    for idx in groups.values():
        mine = torch.cat([leaves[i][1].detach().reshape(-1) for i in idx])
        ref = mesh.broadcast_(mine.clone().to(mesh.device)).to(mine.device)
        at = 0
        for i in idx:
            n = leaves[i][1].numel()
            a, b = mine[at:at + n], ref[at:at + n]
            if a.is_floating_point():
                same = torch.allclose(a.double(), b.double(), rtol=0,
                                      atol=atol, equal_nan=True)
            else:
                same = bool((a == b).all())
            flags[i] = float(not same)
            at += n
    bad = mesh.all_reduce_(torch.tensor(flags, device=mesh.device))
    names = [leaves[i][0] for i in torch.nonzero(bad).flatten().tolist()]
    if names:
        shown = "\n".join(f"  {n}: differs from rank 0"
                          for n in names[:max_report])
        raise AssertionError(f"{len(names)} replicated tensors differ "
                             f"across {mesh.world} ranks:\n{shown}")
    return len(leaves)
