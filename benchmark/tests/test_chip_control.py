"""The check's readings on the card: sound runs of a cell's timed path on
many seeds (the lower reading of each number compared), the control on
three seeds or more, which has to come out not correct (serving: the
port's own bf16 path, ``InpaintEngine(bf16=True)``, below the stated
float32 with TF32 convolutions; training: cuDNN's TF32 on, below the
stated float32 with TF32 off), and a training fault planted in the
program (half of each batch).

As tests (marked ``cuda``; they skip without a card) they run each serving
cell at its own size with a short window.  As a script they print each
run's numbers, one JSON line a run:

    python3 benchmark/tests/test_chip_control.py --workload g512-stream-b8 \\
        --seeds 1 2 3 [--control] [--fault half] [--seconds 3] [--rates 60]

``--rates`` sweeps an open-loop cell's offered rate (the knee: the highest
rate whose queue does not grow).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402,F401  (puts the benchmark on the path)

from harness import runner  # noqa: E402

CELLS = ("g512-stream-b8", "g256-train-b8")


def run_cell(name, seed, seconds, control=False, rate=None, trace=0,
             fault=None):
    """One run of cell ``name`` in this process; ``control``: the
    precision below the configuration's (serving: the engine's bf16 path;
    training: cuDNN's TF32 on); ``fault="half"``: the training step on half
    of each batch, the mean over the rest."""
    import torch
    manifest = runner.load_json(tiny.ROOT / "BENCHMARK.json")
    cell = runner.Cell(manifest, name, seed, seconds, trace,
                       torch.device("cuda", 0))
    if control and "model_g" in cell.config:
        cell.config = dict(cell.config, tf32=True)
    elif control:
        cell.settings = dict(cell.settings, engine=dict(
            cell.settings.get("engine", {}), bf16=True))
    if rate is not None:
        cell.traffic["rate_per_s"] = rate
    torch.cuda.reset_peak_memory_stats()
    undo = []
    if fault == "half":
        from shgan_torch.train import step as step_mod
        call = step_mod.TrainStep.__call__

        def half(self, real, mask, *a, **k):
            n = real.shape[0] // 2
            return call(self, real[:n], mask[:n], *a, **k)
        step_mod.TrainStep.__call__ = half
        undo.append(lambda: setattr(step_mod.TrainStep, "__call__", call))
    try:
        return runner.execute(
            cell, device_fn=lambda: runner.device_info(1),
            log=lambda s: print(s, file=sys.stderr, flush=True))
    finally:
        for u in undo:
            u()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    for seed in (11, 2 ** 31 + 5, 977):
        assert run_cell(name, seed, 3, control=True)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(card, name):
    for seed in (12, 2 ** 31 + 6):
        assert run_cell(name, seed, 3)["correct"] is True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half",))
    ap.add_argument("--rates", type=float, nargs="*")
    ap.add_argument("--trace", type=int, default=0)
    a = ap.parse_args()
    for rate in a.rates or [None]:
        for seed in a.seeds:
            r = run_cell(a.workload, seed, a.seconds, a.control, rate,
                         a.trace, a.fault)
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "control": a.control, "fault": a.fault,
                              "rate": rate,
                              "correct": r["correct"], "checks": r["checks"],
                              "metrics": r["metrics"],
                              "attempted": r["attempted"],
                              "peak": r["device"]["memory_peak_bytes"]}),
                  flush=True)


if __name__ == "__main__":
    main()
