"""Console + log-file tee (port of ``print_log`` / ``set_log_file`` of
``shgan_tpu/runtime/logging.py``)."""

from __future__ import annotations

import os
import os.path as osp
import sys

_LOG_FILE = None


def set_log_file(path):
    """Tee every later :func:`print_log` line to ``path`` (None: stop)."""
    global _LOG_FILE
    if path is not None:
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    _LOG_FILE = path


def print_log(*args):
    msg = " ".join(str(a) for a in args)
    print(msg)
    sys.stdout.flush()
    if _LOG_FILE is not None:
        with open(_LOG_FILE, "a") as f:
            f.write(msg + "\n")
