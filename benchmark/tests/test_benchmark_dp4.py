"""The four-rank training cell ``g256-train-dp4``: its files are found by
name, its three readers on a hand-built run (a trace with NCCL's kernel
names, the port's ``dist.grads`` spans, the mesh's counters), ``mfu.train``
reading one card, and a whole run of its driver on two gloo ranks of the
CPU at a tiny size against the plain reference."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from harness import runner, spans  # noqa: E402
from harness.trace import Trace  # noqa: E402
from shgan_torch.runtime.tracing import Record  # noqa: E402

MANIFEST = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
CELL = "g256-train-dp4"
NEW = ("allreduce_exposed_ms.train", "collectives_per_step.train",
       "grad_allreduce_ms.train")
T_WINDOW = 1000.0                    # s on perf_counter: the window opens
W0 = int(T_WINDOW * 1e9)
MS = 1_000_000


def _read(name, run):
    path = tiny.BENCH / "metrics" / f"{name}.py"
    return runner.load_module(path, "m_" + name.replace(".", "_")).read(run)


def _run(facts, kernels=(), window=(0.0, 1e6)):
    cell = SimpleNamespace(t_window=T_WINDOW, config=json.loads(
        (tiny.BENCH / "configs" / "shgan_ffhq256_train_dp4.json").read_text()))
    trace = Trace(list(kernels), [("bench.window", *window)])
    return runner.Run(cell, facts, trace, "NVIDIA H100 80GB HBM3")


def test_cell_files_found_by_name():
    import torch
    cell = runner.Cell(MANIFEST, CELL, 2 ** 31 + 3, 1, 0, torch.device("cpu"))
    assert cell.entry["chips"] == 4 and cell.traffic["driver"] == "train_dp"
    assert cell.driver_path.is_file()
    assert (tiny.BENCH / "traffic" / "train_dp_rank.py").is_file()
    per = {m["name"] for m in cell.per_layer()}
    assert set(NEW) <= per
    assert {m["name"] for m in MANIFEST["per_layer"]
            if m["name"].endswith(".train")} == per
    for name in per:
        assert callable(cell.reader(name))
    assert [m["name"] for m in cell.end_to_end()] == ["train_images_per_s",
                                                      "setup_s"]
    cfg = cell.config
    assert cfg["reduced"] == ["dataset", "ranks"] and cfg["tf32"] is False
    assert cfg["train"]["ranks"] * cfg["train"]["batch_size_per_gpu"] == 32
    one = json.loads((tiny.BENCH / "configs" / "shgan_ffhq256_train.json")
                     .read_text())
    for key in ("model_g", "model_d"):
        assert cfg[key] == one[key]
    assert {k: v for k, v in cfg["train"].items()
            if k not in ("ranks", "batch_size_per_gpu")} == {
        k: v for k, v in one["train"].items() if k != "batch_size"}
    assert cell.settings["limits"]["replica_gap"] == 0
    assert cell.settings["host_threads"] >= 1
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)


def test_exposed_allreduce_reads_nccl_outside_other_work():
    # window [0, 1000] us; NCCL [100, 300] with a conv over [150, 250]:
    # 100 us exposed; NCCL [600, 700] and [650, 800] alone: 200 us; a copy
    # over [700, 720] hides 20 of them
    kernels = [(100.0, 300.0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
               (150.0, 250.0, "sm90_xmma_fprop_implicit_gemm"),
               (600.0, 700.0, "ncclKernel_AllReduce_RING_LL_Sum_float"),
               (650.0, 800.0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
               (700.0, 720.0, "Memcpy DtoD (Device -> Device)"),
               (900.0, 1200.0, "elementwise_kernel")]
    run = _run({"steps": 2}, kernels, window=(0.0, 1000.0))
    got = _read("allreduce_exposed_ms.train", run)
    assert math.isclose(got, (100 + 200 - 20) / 1e3 / 2)
    assert _read("allreduce_exposed_ms.train",
                 _run({"steps": 2}, kernels[1:2])) is None
    assert _read("allreduce_exposed_ms.train",
                 runner.Run(None, {"steps": 2}, None, "cpu")) is None


def test_collectives_per_step_reads_the_counters():
    run = _run({"steps": 16, "traffic": {"rows_calls": 600,
                                         "grad_calls": 32, "rows_bytes": 1}})
    assert _read("collectives_per_step.train", run) == (600 + 32) / 16
    # a program that keeps no such counters (the parent of the cell)
    old = _run({"steps": 16, "traffic": {"halo_bytes": 0, "sum_bytes": 0}})
    assert _read("collectives_per_step.train", old) is None


def test_grad_allreduce_reads_the_spans_in_the_window(monkeypatch):
    recs = [Record("dist.grads", 1, None, 1, W0 - 5 * MS, W0 - 3 * MS, {}),
            Record("dist.grads", 2, None, 1, W0 + 1 * MS, W0 + 3 * MS, {}),
            Record("dist.grads", 3, None, 1, W0 + 4 * MS, W0 + 8 * MS, {}),
            Record("dist.rows", 4, None, 1, W0 + 4 * MS, W0 + 9 * MS, {})]
    monkeypatch.setattr(spans, "_records", lambda: list(recs))
    run = _run({"steps": 1, "seconds": 1.0})
    assert math.isclose(_read("grad_allreduce_ms.train", run), 3.0)
    monkeypatch.setattr(spans, "_records", lambda: [])
    assert _read("grad_allreduce_ms.train", run) is None


def test_mfu_reads_one_card():
    """``facts["batch"]`` is one rank's 8 rows: the share is one card's,
    the one-rank cell's at the same rate a card."""
    one = json.loads((tiny.BENCH / "configs" / "shgan_ffhq256_train.json")
                     .read_text())
    facts = {"steps": 96, "seconds": 48.0, "batch": 8, "ranks": 4}
    dp4 = _read("mfu.train", _run(facts))
    cell1 = SimpleNamespace(t_window=T_WINDOW, config=one)
    b8 = _read("mfu.train", runner.Run(cell1, dict(facts, ranks=1), None,
                                       "NVIDIA H100 80GB HBM3"))
    assert math.isclose(dp4, b8) and 0 < dp4 < 100


def test_driver_runs_ranks_against_the_reference_on_the_cpu(tmp_path):
    """The driver on two gloo ranks of the CPU at a tiny size, in a
    process of its own (rank 0 joins a process group): correct against the
    plain reference at the global batch, the replicas equal, the counters
    and spans read."""
    world = 2
    code = f"""
import json, sys
sys.path.insert(0, {str(tiny.BENCH / 'tests')!r})
import tiny, torch
torch.set_num_threads(2)
from harness import runner
root, man = tiny.tree({str(tmp_path)!r})
cfg = tiny.tiny_train()
tr = cfg["train"]
del tr["batch_size"]
cfg.update(name="tiny_dp", train=dict(batch_size_per_gpu=8 // {world},
                                      ranks={world}, **tr))
(root / "configs" / "tiny_dp.json").write_text(json.dumps(cfg))
(root / "workloads" / "tiny-dp.json").write_text(json.dumps(
    {{"host_threads": 2, "traffic": {{"images": 32}},
      "limits": {{"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
                  "replica_gap": 0}}}}))
man["configs"].append({{"name": "tiny_dp", "source": "a test", "reduced": [],
                        "file": "benchmark/configs/tiny_dp.json",
                        "why": "CPU tests"}})
man["workloads"].append({{"name": "tiny-dp", "config": "tiny_dp",
                          "traffic": "train-dp4", "chips": {world},
                          "why": "CPU test"}})
for m in man["end_to_end"] + man["per_layer"]:
    if "{CELL}" in m.get("workloads", []):
        m["workloads"].append("tiny-dp")
r = runner.execute(runner.Cell(man, "tiny-dp", 2 ** 31 + 77, 0.5, 1,
                               torch.device("cpu"), root=root),
                   log=lambda s: None)
print(json.dumps(r))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["replica_gap"]["value"] == 0
    assert r["checks"]["loss_gap"]["value"] < 1e-5
    m = r["metrics"]
    assert m["collectives_per_step.train"]["value"] > 2
    assert m["grad_allreduce_ms.train"]["value"] > 0
    assert "allreduce_exposed_ms.train" not in m   # no NCCL on the CPU
