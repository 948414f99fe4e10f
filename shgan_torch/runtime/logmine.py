"""Offline log mining (port of ``shgan_tpu/runtime/logmine.py``): the
metrics of every eval run's ``result.json`` under a log root, as a dict and
as a text table, and the training curves of runs' ``stats.jsonl`` (which
the train stage writes with ``eval_<metric>`` records of its nested eval).
"""

from __future__ import annotations

import json
import os
import os.path as osp


def gather_result(log_root="log", metric_keys=None):
    """Walk ``log_root`` for eval ``result.json`` files.

    Returns ``{relative_run_dir: {metric: value}}``, filtered to
    ``metric_keys`` when given (each metrics dict is flattened as
    ``<evaluator>.<field>``).
    """
    out = {}
    for dirpath, _dirnames, filenames in os.walk(log_root):
        if "result.json" not in filenames:
            continue
        with open(osp.join(dirpath, "result.json")) as f:
            raw = json.load(f)
        flat = {}
        for sym, fields in raw.items():
            if isinstance(fields, dict):
                for k, v in fields.items():
                    flat[f"{sym}.{k}"] = v
            else:
                flat[sym] = fields
        if metric_keys is not None:
            flat = {k: v for k, v in flat.items() if k in metric_keys}
        out[osp.relpath(dirpath, log_root)] = flat
    return out


def format_result_table(results):
    """Plain-text table of :func:`gather_result` output."""
    keys = sorted({k for v in results.values() for k in v})
    rows = [["run"] + keys]
    for run in sorted(results):
        rows.append([run] + [_fmt(results[run].get(k)) for k in keys])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(lines)


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def load_stats(log_dir):
    """Read a training run's ``stats.jsonl`` → list of records."""
    records = []
    with open(osp.join(log_dir, "stats.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def plotter(log_dirs, keys=("loss_g", "loss_d"), out_png=None, labels=None):
    """Plot training curves from one or more runs' stats.jsonl
    (the offline ``plotter`` of log_service.py:401-542).

    Returns the output path (or the matplotlib figure when ``out_png`` is
    None).  Requires matplotlib; raises ImportError otherwise.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(log_dirs, str):
        log_dirs = [log_dirs]
    labels = labels or [osp.basename(osp.normpath(d)) for d in log_dirs]

    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4),
                             squeeze=False)
    for d, lab in zip(log_dirs, labels):
        records = load_stats(d)
        steps = [r["step"] for r in records]
        for ax, key in zip(axes[0], keys):
            vals = [r.get(key) for r in records]
            pts = [(s, v) for s, v in zip(steps, vals) if v is not None]
            if pts:
                ax.plot(*zip(*pts), label=lab)
    for ax, key in zip(axes[0], keys):
        ax.set_xlabel("images seen")
        ax.set_title(key)
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.tight_layout()
    if out_png is None:
        return fig
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
