"""``readback_drained_share.stream`` on hand-built runs: the share of the
window's ``serve.readback`` spans whose ``drained`` is true, and None
where no readback carries the attribute (a port that does not set it)."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_benchmark_spans import BUSY, STREAM, _read, _rec, _run  # noqa: E402

from harness import spans  # noqa: E402

NAME = "readback_drained_share.stream"


def _stream(*drained):
    """STREAM with its readbacks, in order, marked ``drained`` (None leaves
    one unmarked)."""
    marks = iter(drained)
    out = []
    for r in STREAM:
        if r.name == "serve.readback":
            d = next(marks)
            if d is not None:
                r = r._replace(attrs=dict(r.attrs, drained=d))
        out.append(r)
    return out


@pytest.mark.parametrize("drained,want", [
    ((True, False, True), 50.0),        # the third ends past the window
    ((False, False, False), 0.0),
    ((True, True, False), 100.0),
    ((None, True, True), 100.0),        # an unmarked readback is left out
    ((None, None, True), None),         # none marked in the window
    ((None, None, None), None),         # the parent's spans
])
def test_drained_share(monkeypatch, drained, want):
    monkeypatch.setattr(spans, "_records", lambda: _stream(*drained))
    got = _read(NAME, _run(0.1, BUSY))
    assert got is None if want is None else math.isclose(got, want), got


def test_drained_share_counts_only_window_readbacks(monkeypatch):
    recs = _stream(False, False, True) + [
        _rec("serve.readback", -30, -2, 90, drained=True),   # before
        _rec("serve.readback", 90, 99, 91, drained=True)]
    monkeypatch.setattr(spans, "_records", lambda: recs)
    assert math.isclose(_read(NAME, _run(0.1, BUSY)), 100.0 / 3)
    monkeypatch.setattr(spans, "_records", lambda: [])
    assert _read(NAME, _run(0.1, BUSY)) is None
