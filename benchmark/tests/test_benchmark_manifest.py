"""The manifest keeps to the benchmark's rules, every cell's files are
found by name, and a new cell and metric come from new files alone."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from harness import runner  # noqa: E402

MANIFEST = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for n in names + [m["name"] for m in metrics]:
        assert NAME.match(n), n
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all("\n" not in k and len(k) <= 200 for k in layers)


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    import torch
    cell = runner.Cell(MANIFEST, w["name"], 1, 1, 0, torch.device("cpu"))
    assert cell.driver_path.is_file()
    e2e = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = cell.per_layer()
    assert per
    for m in per:
        assert callable(cell.reader(m["name"]))
    cfg = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    data = json.loads((tiny.ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"] and data["name"] == cfg["name"]
    assert "limits" in cell.settings


def test_reduced_names_no_width():
    for c in MANIFEST["configs"]:
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|ch_|channels|width|hidden)", k)


def test_new_cell_and_metric_need_no_edit(tmp_path):
    """A dummy cell and per-layer metric from new files: the harness finds
    and reports them without an edit to any existing file."""
    import torch
    root, manifest = tiny.tree(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "metrics" / "dummy_ms.tiny.py").write_text(
        "def read(run):\n    return 42.0\n")
    (root / "traffic" / "stream-b2.json").write_text(json.dumps(
        {"driver": "stream", "batch": 2, "window": 1, "pool": 4,
         "hole_range": [0, 1]}))
    (root / "workloads" / "tiny-stream-b2.json").write_text(json.dumps(
        {"check_batches": 1, "limits": {"kept_px_changed": 0,
                                        "hole_px_off_pct": 0.5,
                                        "hole_rms_levels": 0.5}}))
    manifest["workloads"].append({"name": "tiny-stream-b2", "config": "tiny",
                                  "traffic": "stream-b2", "chips": 1,
                                  "why": "test"})
    next(m for m in manifest["end_to_end"]
         if m["name"] == "serve_images_per_s")["workloads"].append(
        "tiny-stream-b2")
    manifest["per_layer"].append({
        "name": "dummy_ms.tiny", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "test", "moves": "serve_images_per_s",
        "workloads": ["tiny-stream-b2"]})
    torch.set_num_threads(2)
    cell = runner.Cell(manifest, "tiny-stream-b2", 5, 0.5, 1,
                       torch.device("cpu"), root=root)
    r = runner.execute(cell, log=lambda s: None)
    assert r["correct"] is True
    assert r["metrics"]["dummy_ms.tiny"] == {"value": 42.0, "unit": "ms"}
    cell = runner.Cell(manifest, "tiny-stream-b2", 5, 0.5, 0,
                       torch.device("cpu"), root=root)
    r = runner.execute(cell, log=lambda s: None)
    assert set(r["metrics"]) == {"serve_images_per_s", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
