"""Build the CUDA kernels in ``shgan_torch/csrc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` process (all started
together) into ``build/shgan_torch_kernels/<digest>/lib<name>.so`` at the
root of the checkout.  The digest covers every source and header and the
compiler flags, so an edited source builds anew and an unchanged one loads
the library already built.  The libraries have a plain C interface: each
entry point takes raw device pointers and the CUDA stream, launches on that
stream and returns ``cudaGetLastError()``.

Nothing is built when this module is imported; the CPU paths of the package
never call it.  A CUDA run without ``nvcc`` or with a failing build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "shgan_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
_F = ctypes.c_float
# C entry points: library name -> {symbol: argtypes}
ENTRY_POINTS = {
    "noise": {"shgan_philox_normal": (_P, _I, _I, _LL, _U, _U, _P)},
    "noise_bias_act": {
        "shgan_noise_bias_act": (_P, _P) + (_I,) * 4 + (_P,) * 4
        + (_I, _U, _U, _LL, _F, _F, _F, _P),
        "shgan_noise_bias_act_grad": (_P,) * 3 + (_I,) * 4 + (_P,) * 4
        + (_I, _U, _U, _LL, _F, _F, _F, _I) + (_P,) * 6},
    "upfirdn2d": {"shgan_upfirdn2d": (_P, _P, _I, _LL) + (_I,) * 10
                  + (_P, _I, _I, _P)},
    "conv3x3_lowch": {"shgan_conv3x3_lowch": (_P, _P, _P) + (_I,) * 6
                      + (_P,)},
}

# Launch counts of the kernel wrappers: each wrapper adds one (count())
# where it launches its kernel, and nowhere else; a lock keeps the counts
# exact when several threads launch (the engine over several devices).
# K2's derivative calls (backward and higher orders) count apart from its
# forward calls; the epilogue's grad kernel counts in both of its modes.
launches = {"upfirdn2d": 0, "upfirdn2d_grad": 0, "philox_normal": 0,
            "conv3x3_lowch": 0, "noise_bias_act": 0,
            "noise_bias_act_grad": 0}


_LAUNCH_LOCK = threading.Lock()


def count(name):
    with _LAUNCH_LOCK:
        launches[name] += 1


def reset_launches():
    with _LAUNCH_LOCK:
        for k in launches:
            launches[k] = 0


def find_nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of shgan_torch cannot be built")


def _digest(nvcc):
    h = hashlib.sha256()
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_all():
    """Compile every ``csrc/*.cu`` not yet built for this digest, in
    parallel; returns ``({name: path}, seconds spent building)``."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _digest(nvcc)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths, procs = {}, {}
    for name in ENTRY_POINTS:
        so = out_dir / f"lib{name}.so"
        paths[name] = so
        if so.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode})\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(name):
    """The loaded kernel library ``name`` (building it if needed)."""
    paths, _ = build_all()
    lib = ctypes.CDLL(str(paths[name]))
    for sym, argtypes in ENTRY_POINTS[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(fn, device, *args):
    """Call the C entry point ``fn(*args, stream)`` with the current stream
    of ``device`` (a CUDA device), making it the current device for the
    call; returns the entry point's error code."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(idx).cuda_stream)
    with torch.cuda.device(idx):
        return fn(*args, torch.cuda.current_stream(idx).cuda_stream)


def check(rc, what):
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
