"""The cell g1024-stream-b8 and its metric on the CPU: its files load by
name with the metric sets it reports, the other cells keep theirs, K3's
work at shgan_g1024 batch 8 against a hand count, and the reader on a
hand-built trace."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from harness import conv1024, runner, work  # noqa: E402
from harness.trace import Trace  # noqa: E402

MANIFEST = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
G1024 = json.loads((tiny.BENCH / "configs" / "shgan_g1024.json").read_text())
KIND = "NVIDIA H100 80GB HBM3"

G512_SET = {
    "mfu.stream", "k2_roofline.stream", "epilogue_roofline.stream",
    "device_idle.stream", "engine_host_ms.stream", "readback_wait_ms.stream",
    "idle_under_engine.stream", "graph_replay_share.stream",
    "engine_prepare_ms.stream", "engine_z_ms.stream",
    "compiled_load_ms.stream", "compiled_replay_ms.stream",
    "readback_drained_share.stream"}
STREAM_SETS = {
    "g1024-stream-b8": G512_SET | {"k3_roofline.stream"},
    "g512-stream-b8": G512_SET,
    "g256-train-b8": {
        "mfu.train", "device_ops_per_step.train", "pipe_wait_ms.train",
        "device_idle.train", "step_host_ms.train", "pipe_build_ms.train",
        "pipe_ready_share.train", "pipe_midepoch_ready_share.train"},
}
E2E = {"g1024-stream-b8": {"serve_images_per_s", "setup_s"},
       "g512-stream-b8": {"serve_images_per_s", "setup_s"},
       "g256-train-b8": {"train_images_per_s", "setup_s"}}


@pytest.mark.parametrize("name", sorted(STREAM_SETS))
def test_each_cell_reports_its_metric_set(name):
    cell = runner.Cell(MANIFEST, name, 2 ** 31 + 5, 1, 1, torch.device("cpu"))
    assert {m["name"] for m in cell.end_to_end()} == E2E[name]
    assert {m["name"] for m in cell.per_layer()} == STREAM_SETS[name]
    for m in cell.per_layer():
        assert callable(cell.reader(m["name"]))


def test_g1024_cell_files():
    """The configuration is the model bank's shgan_g1024, nothing cut, and
    the cell's engine settings are those of g512-stream-b8 (the engine
    routes K3 itself)."""
    from shgan_torch.runtime.config import model_cfg_bank
    cell = runner.Cell(MANIFEST, "g1024-stream-b8", 1, 1, 0,
                       torch.device("cpu"))
    assert cell.config["model"] == json.loads(
        json.dumps(model_cfg_bank()("shgan_g1024")))
    assert cell.config["reduced"] == [] and cell.config["tf32"] is True
    g512 = runner.Cell(MANIFEST, "g512-stream-b8", 1, 1, 0,
                       torch.device("cpu"))
    assert cell.settings["engine"] == g512.settings["engine"] == {
        "noise_mode": "random"}
    assert cell.traffic["batch"] == 8 and cell.traffic["window"] == 2
    assert set(cell.settings["limits"]) == {
        "kept_px_changed", "hole_px_off_pct", "hole_rms_levels"}


def test_k3_work_hand_count():
    """shgan_g1024 at batch 8: K3 runs two convs, 32 -> 32 channels at
    1024² (the encoder's b1024 conv0 and the synthesis's b1024 conv1); each
    reads 8·32·1024² float32 inputs and 32·32·9 weights and writes
    8·32·1024² outputs, and does 8·1024²·32·32·9 multiply-adds."""
    px = 1024 * 1024
    want_bytes = 2 * 4 * (8 * 32 * px + 8 * 32 * px + 32 * 32 * 9)
    want_flops = 2 * 2 * 8 * px * 32 * 32 * 9
    model = G1024["model"]
    assert conv1024.eligible_convs(model) == [(32, 32, 1024)] * 2
    assert conv1024.k3_work(model, 8) == (want_bytes, want_flops)
    # bound by the bytes: 4.295 GB at 3.35 TB/s against 309 GFLOP at the
    # TF32 rate (0.625 ms)
    ms = conv1024.least_ms(want_bytes, want_flops, KIND, G1024)
    assert math.isclose(ms, want_bytes / 3.35e12 * 1e3)
    assert abs(ms - 1.282) < 1e-3
    assert work.peak_flops(KIND, G1024) == 495e12
    g512 = json.loads((tiny.BENCH / "configs" / "shgan_g512.json")
                      .read_text())
    assert conv1024.eligible_convs(g512["model"]) == []
    assert conv1024.k3_work(g512["model"], 8) == (0, 0)


def _read(name, run):
    path = tiny.BENCH / "metrics" / f"{name}.py"
    return runner.load_module(path, "m_" + name.replace(".", "_")).read(run)


def _trace(kernels):
    return Trace(kernels, [("bench.window", 0.0, 100e3)])


def test_k3_roofline_reads_the_k3_kernels():
    """Three batches of 8, K3's kernels 4 ms each a batch on the trace,
    among others not K3's: the least time of the three over 12 ms."""
    ker = []
    for b in range(3):
        t0 = b * 30e3
        ker += [(t0, t0 + 2e3, "void (anonymous namespace)::"
                 "conv3x3_lowch_f32_kernel((anonymous namespace)::Args)"),
                (t0 + 2e3, t0 + 9e3, "sm90_xmma_fprop_implicit_gemm"),
                (t0 + 9e3, t0 + 11e3, "conv3x3_lowch_f32_kernel")]
    cell = SimpleNamespace(config=G1024)
    run = runner.Run(cell, {"batches": [8, 8, 8]}, _trace(ker), KIND)
    least = 3 * conv1024.least_ms(*conv1024.k3_work(G1024["model"], 8),
                                  KIND, G1024)
    assert math.isclose(_read("k3_roofline.stream", run),
                        100.0 * least / 12.0)
    # nothing to read: no K3 kernel, no trace, no batch, a card not known
    no_k3 = [k for k in ker if "lowch" not in k[2]]
    for r in (runner.Run(cell, {"batches": [8]}, _trace(no_k3), KIND),
              runner.Run(cell, {"batches": [8]}, None, KIND),
              runner.Run(cell, {"batches": []}, _trace(ker), KIND),
              runner.Run(cell, {"batches": [8]}, _trace(ker), "cpu")):
        assert _read("k3_roofline.stream", r) is None

