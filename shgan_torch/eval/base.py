"""Evaluator base, registry and compose (port of ``shgan_tpu/eval/base.py``),
with the hooks of the metrics that drive the generator themselves (PPL:
``needs_generator``, ``run_generator_metrics``).

Evaluators receive batches plus a validity mask that marks the rows padding
the last batch, accumulate per-image values or features, and write
``result.json`` like the reference's ``compose.save``.  Across ranks each
rank adds its own rows; :meth:`BaseEvaluator.sync_across_processes`, which
every rank calls before ``compute``, gathers them in rank order (the
ranks' shards are contiguous, so that is the dataset's order).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

_EVALUATOR_REGISTRY = {}


def register_evaluator(name):
    def wrap(cls):
        _EVALUATOR_REGISTRY[name] = cls
        cls.symbol = name
        return cls
    return wrap


def get_evaluator(cfg):
    """cfg: list of {'type': name, 'args': {...}} → ComposeEvaluator."""
    if isinstance(cfg, (list, tuple)):
        return ComposeEvaluator([_build(c) for c in cfg])
    return _build(cfg)


def _build(c):
    if c["type"] not in _EVALUATOR_REGISTRY:
        raise KeyError(f"unknown evaluator {c['type']!r}; the registry has "
                       f"{sorted(_EVALUATOR_REGISTRY)}")
    return _EVALUATOR_REGISTRY[c["type"]](**dict(c.get("args") or {}))


class BaseEvaluator:
    symbol = "base"
    # metrics that drive the generator themselves (PPL): the eval stage
    # hands them the masks and calls run_generator_metrics(G, seed) after
    # the batch stream
    needs_generator = False
    # False on metrics that read only the device views (fake_dev, real_dev,
    # pred_dev, gt_dev): when no composed metric reads host pixels, the eval
    # stage skips the full-image device→host copy
    consumes_host_pixels = True
    # True on metrics that read the device views
    consumes_device_views = False

    def __init__(self):
        self.final = {}
        self.sample_n = None

    def set_sample_n(self, n):
        self.sample_n = n

    def run_generator_metrics(self, G, seed=0):
        pass

    @staticmethod
    def _log(msg):
        from ..runtime.logging import print_log
        print_log(msg)

    def add_batch(self, **kwargs):
        raise NotImplementedError

    def compute(self):
        raise NotImplementedError

    def one_line_summary(self):
        self._log("Evaluator {}: {}".format(self.symbol, self.final))

    def clear_data(self):
        pass

    def sync_across_processes(self):
        """Gather the accumulated rows of every rank, in rank order, into
        each accumulator (``data`` or ``data_*``: lists of ``[n_i, ...]``
        arrays or tensors), through :func:`~..parallel.allgather_rows`'s
        byte transport: each dtype kept bit for bit.  Every rank must call
        it (it runs collectives); which accumulators are empty is fixed by
        the config, so it is the same on every rank."""
        from ..parallel import allgather_rows
        for name, val in list(self.__dict__.items()):
            if (name == "data" or name.startswith("data_")) \
                    and isinstance(val, list) and val:
                local = np.concatenate([
                    v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v) for v in val], axis=0)
                setattr(self, name, [allgather_rows(local)])

    def drain(self):
        """Wait for the device work queued into the accumulators (feature
        banks stay on the device until ``compute``)."""
        for name, val in self.__dict__.items():
            if (name == "data" or name.startswith("data_")) \
                    and isinstance(val, list):
                for last in reversed(val):
                    if isinstance(last, torch.Tensor) and last.is_cuda:
                        torch.cuda.synchronize(last.device)
                        return

    @staticmethod
    def _apply_valid(arrays, valid):
        """Drop the rows that pad the last batch.  All-valid batches pass
        through untouched (device tensors stay on the device)."""
        if valid is None:
            return arrays
        valid = np.asarray(valid, bool)
        if valid.all():
            return arrays
        out = []
        for a in arrays:
            if isinstance(a, torch.Tensor):
                a = a[torch.from_numpy(valid).to(a.device)]
            elif a is not None:
                a = np.asarray(a)[valid]
            out.append(a)
        return out


@register_evaluator("null")
class NullEvaluator(BaseEvaluator):
    """No-op metric, for runs that only want the demo grid."""

    consumes_host_pixels = False

    def add_batch(self, **kwargs):
        pass

    def compute(self):
        self.final = {"null": None}
        return None


class ComposeEvaluator:
    """Multi-metric pipeline with the result.json save."""

    def __init__(self, evaluators):
        self.evaluators = evaluators
        self.sample_n = None

    def add_batch(self, **kwargs):
        for e in self.evaluators:
            e.add_batch(**kwargs)

    def set_sample_n(self, n):
        self.sample_n = n
        for e in self.evaluators:
            e.set_sample_n(n)

    @property
    def needs_generator(self):
        return any(e.needs_generator for e in self.evaluators)

    @property
    def consumes_host_pixels(self):
        return any(e.consumes_host_pixels for e in self.evaluators)

    @property
    def consumes_device_views(self):
        return any(e.consumes_device_views for e in self.evaluators)

    def run_generator_metrics(self, G, seed=0):
        for i, e in enumerate(self.evaluators):
            if e.needs_generator:
                e.run_generator_metrics(G, seed=seed + i)

    def drain(self):
        for e in self.evaluators:
            e.drain()

    def sync_across_processes(self):
        for e in self.evaluators:
            e.sync_across_processes()

    def compute(self):
        return {e.symbol: e.compute() for e in self.evaluators}

    def one_line_summary(self):
        for e in self.evaluators:
            e.one_line_summary()

    def clear_data(self):
        for e in self.evaluators:
            e.clear_data()

    def save(self, log_dir):
        """Merge every evaluator's ``final`` into ``log_dir/result.json``."""
        results = {e.symbol: _jsonable(e.final) for e in self.evaluators}
        os.makedirs(log_dir, exist_ok=True)
        path = osp.join(log_dir, "result.json")
        if osp.exists(path):
            with open(path) as f:
                old = json.load(f)
            old.update(results)
            results = old
        with open(path, "w") as f:
            json.dump(results, f, indent=2)
        return path


def _jsonable(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.floating, np.integer)):
            v = v.item()
        out[k] = v
    return out
