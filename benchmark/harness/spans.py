"""The port's own spans (``shgan_torch/runtime/tracing.py``) in a traced
run's window, for the per-layer metrics that read them.

The window is the run's timed stretch on the host's ``perf_counter``: from
``cell.t_window`` for the driver's ``facts["seconds"]``.  The spans are
stamped on the same clock; a reader that sets them beside the device's
activity moves them onto the profiler's timeline by an anchor, a moment
known on both clocks (see ``metrics/idle_under_engine.stream.py``).  A port
that records no spans (no such module, or none recorded) gives nothing,
and the metrics that read them are left out.
"""

from __future__ import annotations


def _records():
    try:
        from shgan_torch.runtime import tracing
    except ImportError:
        return []
    return tracing.spans()


def window_ns(run):
    lo = int(run.cell.t_window * 1e9)
    return lo, lo + int(run.facts["seconds"] * 1e9)


def in_window(run, name, ended=False):
    """The spans named ``name`` inside the window, or with ``ended`` those
    that ended in it."""
    if run.cell.t_window is None or not run.facts.get("seconds"):
        return []
    lo, hi = window_ns(run)
    return [r for r in _records() if r.name == name and lo <= r.t1 <= hi
            and (ended or r.t0 >= lo)]


def since_window(run, name):
    """The spans named ``name`` that began in the window or after it."""
    if run.cell.t_window is None:
        return []
    lo = run.cell.t_window * 1e9
    return [r for r in _records() if r.name == name and r.t0 >= lo]


def per_parent_ms(run, parent, name):
    """The mean time a ``parent`` span of the window spends in its child
    spans named ``name`` (ms, 0 for a parent without one), or None where
    no such child was recorded."""
    parents = {r.id for r in in_window(run, parent)}
    kids = [r for r in _records() if r.name == name and r.parent in parents]
    if not kids:
        return None
    return sum(r.t1 - r.t0 for r in kids) / len(parents) / 1e6


def mean_ms(records):
    if not records:
        return None
    return sum(r.t1 - r.t0 for r in records) / len(records) / 1e6


def share(records, keep):
    """The percentage of ``records`` for which ``keep(record)`` holds."""
    if not records:
        return None
    return 100.0 * sum(bool(keep(r)) for r in records) / len(records)
