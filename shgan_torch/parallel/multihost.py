"""Multi-process execution on ``torch.distributed`` (port of
``shgan_tpu/parallel/multihost.py``).

One process per device, PyTorch's idiom and the reference's (``mp.spawn`` +
NCCL, SURVEY §2.3).  The conventions are the JAX package's:

* every rank computes identical replicated values (configs, weights, the
  step's CPU generator, z and noise keys) from the shared seed: nothing to
  broadcast but the experiment id;
* the rows a rank holds are contiguous in the global order, so rows gathered
  in rank order restore the global order;
* rank 0 is the writer (logs, snapshots, ``result.json``).

Process groups.  The default group is gloo: the host collectives
(:func:`allgather_rows`, barriers, the experiment id) run on it.  The device
collectives (gradients, the batch-wide statistics, replica checks) run on
the group :func:`device_group` picks by rule, not by fallback: NCCL when
every rank has a CUDA device of its own, gloo on the CPU or when ranks share
a device (NCCL refuses two ranks on one device; gloo's all-reduce and
broadcast take CUDA tensors).
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

# this process's distributed state, set once by maybe_initialize_distributed
# (the process group itself is torch.distributed's process-wide state)
_STATE = {"device": None, "devices": None, "groups": {}}


def dist_env():
    """(init_method, world, rank, local index or None) from the environment,
    or None: ``SHGAN_DIST_COORDINATOR`` + ``SHGAN_DIST_NPROCS`` +
    ``SHGAN_DIST_PID`` (the JAX package's names) first, then torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK``."""
    coord = os.environ.get("SHGAN_DIST_COORDINATOR")
    if coord:
        return (f"tcp://{coord}", int(os.environ["SHGAN_DIST_NPROCS"]),
                int(os.environ["SHGAN_DIST_PID"]), None)
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        local = os.environ.get("LOCAL_RANK")
        return ("env://", int(os.environ["WORLD_SIZE"]),
                int(os.environ.get("RANK", 0)),
                None if local is None else int(local))
    return None


def rank_device(rank, local=None, device=None):
    """A rank's device: ``device`` as given (``"cpu"`` asks for the CPU),
    else ``cuda:<local>`` with ``local`` the rank's local index (torchrun's
    ``LOCAL_RANK``), else ``cuda:<rank mod the device count>``; raises
    without CUDA."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device "
                           "cpu) to run the ranks on the CPU")
    idx = local if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", idx)


def maybe_initialize_distributed(device=None, timeout_s=1800):
    """Join the process group the environment names (see :func:`dist_env`):
    ``init_process_group`` with gloo, then every rank's (host, device) is
    shared so :func:`device_group` can apply its rule.  ``device`` is this
    rank's device (default :func:`rank_device`).  Without such an
    environment (or once joined) nothing happens.  Must run before the
    process uses its device.  Returns ``(rank, world)``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = dist_env()
    if env is None:
        return 0, 1
    init_method, world, rank, local = env
    dev = rank_device(rank, local, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    devices = [None] * world
    dist.all_gather_object(devices, (socket.gethostname(), str(dev)))
    _STATE.update(device=dev, devices=devices, groups={})
    return rank, world


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_lead():
    """True on the writer process (rank 0, or no process group)."""
    return rank() == 0


def local_device():
    """The device :func:`maybe_initialize_distributed` gave this rank, or
    None."""
    return _STATE["device"]


def pick_backend(devices, asked=None):
    """The device backend for ranks on ``devices`` (``(host, device)``
    pairs, one a rank): NCCL when every rank has a CUDA device of its own,
    else gloo; ``asked`` names one, and NCCL on a CPU or a shared device
    raises."""
    cuda = all(d.startswith("cuda") for _, d in devices)
    shared = len(set(devices)) < len(devices)
    if asked not in (None, "nccl", "gloo"):
        raise ValueError(f"dist_backend {asked!r}: 'nccl' or 'gloo'")
    if asked == "nccl" and not cuda:
        raise ValueError("dist_backend nccl needs a CUDA device on every "
                         f"rank, got {[d for _, d in devices]}")
    if asked == "nccl" and shared:
        raise ValueError(
            "dist_backend nccl with two ranks on one device: NCCL refuses "
            "it (duplicate GPU); give each rank its own device or use gloo "
            f"(ranks' devices {[d for _, d in devices]})")
    if asked is not None:
        return asked
    return "nccl" if cuda and not shared else "gloo"


def device_group(asked=None):
    """(backend, group) of the device collectives: the default gloo group,
    or an NCCL group made once (every rank must ask in the same order)."""
    if not dist.is_initialized():
        return None, None
    devices = _STATE["devices"]
    if devices is None:
        raise RuntimeError("the process group was joined without "
                           "maybe_initialize_distributed: the ranks' "
                           "devices are unknown")
    backend = pick_backend(devices, asked)
    if backend == "gloo":
        return "gloo", None
    if "nccl" not in _STATE["groups"]:
        _STATE["groups"]["nccl"] = dist.new_group(backend="nccl")
    return "nccl", _STATE["groups"]["nccl"]


def barrier():
    """All ranks meet (the default gloo group); nothing without a group."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src=0):
    """``obj`` of rank ``src`` on every rank (itself without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def local_rows(arr):
    """This rank's rows of a batch: a rank only ever holds its own, so the
    rows are the array itself (numpy)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def allgather_rows(arr):
    """Concatenate every rank's ``[n_r, ...]`` host array in rank order
    (contiguous shards: the global order).  Row counts may differ.  Rows
    ride the gloo gather as raw bytes, so every dtype survives bit for bit:
    the float64 feature banks and bool validity rows included."""
    arr = local_rows(arr)
    if world_size() == 1:
        return arr
    dtype, tail = arr.dtype, arr.shape[1:]
    n = arr.shape[0]
    row_bytes = int(np.prod(tail, dtype=np.int64)) * dtype.itemsize
    rows = np.ascontiguousarray(arr).reshape(n, -1).view(np.uint8) \
        if n else np.zeros((0, row_bytes), np.uint8)
    w = world_size()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(w)]
    dist.all_gather(counts, torch.tensor([n], dtype=torch.int64))
    counts = [int(c) for c in counts]
    m = max(counts)
    if m == 0:
        return arr[:0]
    pad = np.zeros((m, row_bytes), np.uint8)
    pad[:n] = rows
    parts = [torch.zeros((m, row_bytes), dtype=torch.uint8) for _ in range(w)]
    dist.all_gather(parts, torch.from_numpy(pad))
    out = np.concatenate([p.numpy()[:c] for p, c in zip(parts, counts)])
    return out.view(dtype).reshape((out.shape[0],) + tail)
