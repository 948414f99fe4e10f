"""The per-layer metrics that read the port's spans, each on a hand-built
run: known spans on the host's clock, a window, and (for the idle share)
known device busy intervals on the profiler's clock."""

from __future__ import annotations

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from harness import runner, spans  # noqa: E402
from harness.trace import Trace  # noqa: E402
from shgan_torch.runtime.tracing import Record  # noqa: E402

MS = 1_000_000                       # ns
T_WINDOW = 1000.0                    # s on perf_counter: the window opens
W0 = int(T_WINDOW * 1e9)             # ... here in ns
P0 = 5_000.0                         # ... and here on the profiler's clock


def _rec(name, a_ms, b_ms, rid=0, par=None, **attrs):
    return Record(name, rid, par, 1, W0 + int(a_ms * MS),
                  W0 + int(b_ms * MS), attrs)


def _run(seconds, busy_us=(), early_us=0.0):
    """A run whose window is ``seconds`` long; the device busy over
    ``busy_us`` (microseconds after the window opens); ``bench.window``
    opens ``early_us`` before the window and closes as the last readback
    (1 ms after the window) returns."""
    cell = SimpleNamespace(t_window=T_WINDOW)
    dev = [(P0 + a, P0 + b, "k") for a, b in busy_us]
    trace = Trace(dev, [("bench.window", P0 - early_us,
                         P0 + seconds * 1e6 + 1e3)])
    return runner.Run(cell, {"seconds": seconds}, trace, "cpu")


def _read(name, run):
    path = tiny.BENCH / "metrics" / f"{name}.py"
    return runner.load_module(path, "m_" + name.replace(".", "_")).read(run)


STREAM = [
    _rec("serve.batch", -5, -1, 1, path="capture"),   # before
    _rec("serve.z", -4, -3, 2, 1),
    _rec("compiled.replay", -3, -1, 3, 1),
    _rec("serve.batch", 0, 4, 4, path="replay"),
    _rec("serve.prepare", 0, 0.5, 5, 4),
    _rec("serve.z", 1, 3, 6, 4),
    _rec("compiled.load", 3, 3.5, 7, 4),
    _rec("serve.readback", 4, 34, 8),
    _rec("serve.batch", 34, 40, 9, path="replay"),
    _rec("serve.prepare", 34, 35, 10, 9),
    _rec("serve.z", 35, 37, 11, 9),
    _rec("compiled.load", 37, 38, 12, 9),
    _rec("compiled.replay", 38, 40, 13, 9),
    _rec("serve.readback", 40, 70, 14),
    _rec("serve.batch", 70, 76, 15, path="eager"),
    _rec("serve.prepare", 70, 70.5, 16, 15),
    _rec("serve.z", 71, 74, 17, 15),
    _rec("compiled.load", 74, 75, 18, 15),
    _rec("serve.readback", 76, 101, 19),   # the drain's, past the end
]
# the device busy [2, 36], [38, 72] and [80, 100] ms: idle 0-2 (under the
# first batch), 36-38 (under the second), 72-80 (4 of it under the third)
BUSY = [(2e3, 36e3), (38e3, 72e3), (80e3, 100e3)]
TRAIN = [
    _rec("train.step", 0, 300),
    _rec("train.step", 310, 610),
    _rec("train.step", 990, 1100),         # after
    _rec("data.build", -30, 10),           # began before, ended inside
    _rec("data.build", 20, 50),
    _rec("data.build", 900, 1050),         # ended after
    _rec("data.wait", -10, -5, ready=False, epoch_batch=1),   # before
    _rec("data.wait", 300, 310, ready=False, epoch_batch=0),
    _rec("data.wait", 610, 611, ready=True, epoch_batch=1),
    _rec("data.wait", 700, 702, ready=True, epoch_batch=2),
    _rec("data.wait", 800, 801, ready=True, epoch_batch=3),
    _rec("data.wait", 850, 860, ready=False, epoch_batch=4),
]

CASES = [
    ("engine_host_ms.stream", STREAM, 0.1, (4 + 6 + 6) / 3),
    ("readback_wait_ms.stream", STREAM, 0.1, 30.0),
    ("idle_under_engine.stream", STREAM, 0.1, 100.0 * (2 + 2 + 4) / 12),
    ("graph_replay_share.stream", STREAM, 0.1, 100.0 * 2 / 3),
    ("engine_prepare_ms.stream", STREAM, 0.1, (0.5 + 1 + 0.5) / 3),
    ("engine_z_ms.stream", STREAM, 0.1, (2 + 2 + 3) / 3),
    ("compiled_load_ms.stream", STREAM, 0.1, (0.5 + 1 + 1) / 3),
    ("compiled_replay_ms.stream", STREAM, 0.1, 2 / 3),
    ("step_host_ms.train", TRAIN, 1.0, 300.0),
    ("pipe_build_ms.train", TRAIN, 1.0, (40 + 30) / 2),
    ("pipe_ready_share.train", TRAIN, 1.0, 60.0),
    ("pipe_midepoch_ready_share.train", TRAIN, 1.0, 75.0),
]


@pytest.mark.parametrize("name,recs,seconds,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_on_known_spans(monkeypatch, name, recs, seconds, want):
    monkeypatch.setattr(spans, "_records", lambda: list(recs))
    got = _read(name, _run(seconds, BUSY))
    assert math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-6), (got, want)
    # a port that records no span: the metric is left out
    monkeypatch.setattr(spans, "_records", lambda: [])
    assert _read(name, _run(seconds, BUSY)) is None


def test_idle_share_anchors_at_the_window_end(monkeypatch):
    """``bench.window`` opening 1.2 ms early (a process's first
    ``record_function``) moves nothing: the spans are placed by the last
    readback, which ends as the window closes."""
    monkeypatch.setattr(spans, "_records", lambda: list(STREAM))
    want = _read("idle_under_engine.stream", _run(0.1, BUSY))
    got = _read("idle_under_engine.stream", _run(0.1, BUSY, early_us=1200))
    assert math.isclose(got, want, rel_tol=1e-9)


def test_no_tracing_module_reads_nothing(monkeypatch):
    """The parent's port has no ``runtime/tracing``: the readers return
    None and do not raise."""
    import shgan_torch.runtime as rt
    from shgan_torch.runtime import tracing
    with tracing.thread_span("serve.batch", path="replay"):
        pass
    try:
        assert spans._records()
        monkeypatch.setitem(sys.modules, "shgan_torch.runtime.tracing", None)
        monkeypatch.delattr(rt, "tracing")
        assert spans._records() == []
        for name, _, seconds, _ in CASES:
            assert _read(name, _run(seconds, BUSY)) is None
    finally:
        tracing.clear()
