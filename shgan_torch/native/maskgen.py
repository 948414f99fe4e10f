"""ctypes binding for the native batch mask generator (``src/maskgen.cpp``,
a copy of ``shgan_tpu/native/src/maskgen.cpp``; port of
``shgan_tpu/native/maskgen.py``).

The library is built with ``g++`` at first use into
``build/shgan_torch_native/<digest>/`` at the root of the checkout (the
digest covers the compiler, the flags, the source and the host CPU, since
the build is ``-march=native``) and loaded with ctypes.  A failed or
impossible build leaves :func:`native_available` false: ``impl="auto"``
callers then use the numpy masks of :mod:`shgan_torch.data.masks`,
``impl="native"`` raises.  ``SHGAN_DISABLE_NATIVE=1`` disables the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "maskgen.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "shgan_torch_native")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread", "-fvisibility=hidden")

_LOCK = threading.Lock()
_STATE = {}   # "lib" (a CDLL) or "err" (why there is none), once tried


def _host_cpu():
    """The host CPU's architecture, model and feature flags, as far as the
    platform tells them."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    parts.append(line.strip())
                if len(parts) == 3:
                    break
    except OSError:
        parts.append(platform.processor())
    return "\n".join(parts)


def _build():
    if os.environ.get("SHGAN_DISABLE_NATIVE") == "1":
        raise RuntimeError("disabled via SHGAN_DISABLE_NATIVE")
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found")
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_host_cpu().encode())   # -march=native: never load a foreign build
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libshgan_maskgen.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # a private temporary name, then an atomic rename: processes that
        # build at once each publish a whole library
        tmp = out_dir / f"libshgan_maskgen.so.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr[-2000:])
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    if lib.shgan_native_abi_version() != 1:
        raise RuntimeError("maskgen ABI version mismatch")
    lib.shgan_random_mask_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_uint64, ctypes.c_int32]
    lib.shgan_random_mask_batch.restype = ctypes.c_int32
    return lib


def _load():
    """The loaded library, or None (the reason is in ``load_error()``)."""
    with _LOCK:
        if not _STATE:
            try:
                _STATE["lib"] = _build()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _STATE["err"] = e
        return _STATE.get("lib")


def native_available():
    return _load() is not None


def load_error():
    _load()
    return _STATE.get("err")


def random_mask_batch(n, s, hole_range=(0.0, 1.0), seed=0, num_threads=0,
                      impl="auto"):
    """Batch of freeform masks, float32 ``[n, 1, s, s]``, 1 = keep.

    impl: "native" (require the C++ library), "numpy", or "auto"."""
    if impl not in ("auto", "native", "numpy"):
        raise ValueError(impl)
    lib = _load() if impl != "numpy" else None
    if lib is None:
        if impl == "native":
            raise RuntimeError(f"native maskgen unavailable: {load_error()}")
        from ..data.masks import random_mask
        from ..data.rng import batch_rng
        with batch_rng(seed & 0x7FFFFFFF):
            return np.stack([random_mask(s, hole_range) for _ in range(n)])

    if num_threads <= 0:
        try:
            num_threads = len(os.sched_getaffinity(0))
        except AttributeError:  # non-Linux
            num_threads = os.cpu_count() or 1
    out = np.empty((n, 1, s, s), dtype=np.float32)
    rc = lib.shgan_random_mask_batch(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int32(s),
        ctypes.c_float(hole_range[0]), ctypes.c_float(hole_range[1]),
        ctypes.c_uint64(seed), ctypes.c_int32(num_threads))
    if rc == 2:
        raise RuntimeError(
            f"hole_range {tuple(hole_range)} not satisfied within the "
            "native attempt cap (10000) for some mask")
    if rc != 0:
        raise RuntimeError(f"shgan_random_mask_batch rc={rc}")
    return out
