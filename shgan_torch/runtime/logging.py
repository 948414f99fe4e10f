"""Console + log-file tee and the train stage's scalar log (port of
``print_log``, ``set_log_file`` and ``ScalarLogger`` of
``shgan_tpu/runtime/logging.py``)."""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
import time

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


class ScalarLogger:
    """Weighted scalar accumulator; ``flush(step)`` appends ``{"step",
    "time", <means>}`` to ``<log_dir>/stats.jsonl`` and, with
    ``tensorboard``, writes the means as events under
    ``<log_dir>/tensorboard`` (none where tensorboard is not installed)."""

    def __init__(self, log_dir=None, tensorboard=False):
        self.log_dir = log_dir
        self.acc = {}
        self.tb = None
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(osp.join(log_dir, "stats.jsonl"), "at")
            if tensorboard:
                try:
                    from torch.utils import tensorboard as tbmod
                    self.tb = tbmod.SummaryWriter(
                        osp.join(log_dir, "tensorboard"))
                except ImportError:
                    print_log("log_tensorboard: tensorboard is not "
                              "installed, no events are written")

    def accumulate(self, scalars, weight=1.0):
        for k, v in scalars.items():
            s, w = self.acc.get(k, (0.0, 0.0))
            self.acc[k] = (s + float(v) * weight, w + weight)

    def flush(self, step):
        means = {k: s / max(w, 1e-12) for k, (s, w) in self.acc.items()}
        self.acc = {}
        record = {"step": int(step), "time": time.time(), **means}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self.tb is not None:
            for k, v in means.items():
                self.tb.add_scalar(k, v, global_step=int(step))
            self.tb.flush()
        return means

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self.tb is not None:
            self.tb.close()
