"""The yardstick on the CPU: traffic and inputs are functions of the seed,
the open loop's arithmetic, the FLOP and byte counts, the trace's
reduction, and the plain reference against the port's CPU path."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from harness import inputs, runner, work  # noqa: E402
from harness.trace import Trace, group_of  # noqa: E402

sys.path.insert(0, str(tiny.BENCH / "traffic"))
import open_loop  # noqa: E402

G512 = json.loads((tiny.BENCH / "configs" / "shgan_g512.json").read_text())
TRAIN = json.loads((tiny.BENCH / "configs" / "shgan_ffhq256_train.json")
                   .read_text())


def test_inputs_deterministic_in_seed():
    big = 2 ** 31 + 977
    a_img, a_mask = inputs.pool(big, 3, 64)
    b_img, b_mask = inputs.pool(big, 3, 64)
    assert np.array_equal(a_img, b_img) and np.array_equal(a_mask, b_mask)
    c_img, _ = inputs.pool(big + 1, 3, 64)
    assert not np.array_equal(a_img, c_img)
    assert a_img.dtype == np.uint8 and a_mask.dtype == np.uint8
    holes = 1 - a_mask.mean(axis=(1, 2, 3))
    assert ((holes > 0) & (holes < 1)).all()
    tmpl = {"mapping.fc0.weight": torch.empty(4, 4, device="meta"),
            "b.affine.bias": torch.empty(3, device="meta"),
            "b.noise_strength": torch.empty((), device="meta")}
    w1 = inputs.weights(tmpl, G512["model"], big, "cpu")
    w2 = inputs.weights(tmpl, G512["model"], big, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in tmpl)
    assert 50 < float(w1["mapping.fc0.weight"].std()) < 200   # N(0,1)/0.01
    assert abs(float(w1["b.affine.bias"].mean()) - 1) < 0.3


def test_schedule_same_work_every_seed():
    a = open_loop.schedule(2 ** 31 + 3, 50.0, 30.0, 0.5, 8)
    b = open_loop.schedule(2 ** 31 + 3, 50.0, 30.0, 0.5, 8)
    c = open_loop.schedule(7, 50.0, 30.0, 0.5, 8)
    assert a == b and a != c
    assert len(a) == 1500
    assert sorted(k for _, k in a) == sorted(k for _, k in c)
    assert 29 < a[-1][0] < 30.5 and a[0][0] == 0.0
    mean = sum(k for _, k in a) / len(a)
    assert abs(mean - 1.9686) < 0.01
    assert abs(sum(k == 1 for _, k in a) / len(a) - 0.502) < 0.002


def test_open_loop_arithmetic_on_a_fake_engine():
    """Due times are kept, a request starts at the later of its due time
    and the previous one's end (first come, first served), and latency
    counts from the due time."""
    now = [0.0]
    service = {0: 0.05, 1: 0.30, 2: 0.05, 3: 0.05}
    plan = [(0.0, "a"), (0.1, "b"), (0.2, "c"), (1.0, "d")]
    slept = []

    def serve(i, payload):
        now[0] += service[i]

    def sleep(s):
        slept.append(s)
        now[0] += s

    times, _ = open_loop.open_loop(plan, serve, clock=lambda: now[0],
                                   sleep=sleep)
    assert [round(s, 9) for _, s, _ in times] == [0.0, 0.1, 0.4, 1.0]
    assert [round(e, 9) for _, _, e in times] == [0.05, 0.4, 0.45, 1.05]
    lat = [round(e - d, 9) for d, _, e in times]
    assert lat == [0.05, 0.3, 0.25, 0.05]
    assert [round(s, 9) for s in slept] == [0.05, 0.55]
    assert open_loop.p95([float(i) for i in range(101)]) == 95.0
    # a request not started by the stop: its latency is its wait until then
    now[0] = 0.0
    times, _ = open_loop.open_loop(plan, serve, clock=lambda: now[0],
                                   sleep=sleep, stop=0.4)
    assert len(times) == 2
    lat = open_loop.latencies(plan, times, 0.4)
    assert [round(x, 9) for x in lat] == [0.05, 0.3, 0.2, -0.6]
    assert [round(x, 9) for x in open_loop.latencies(plan, times, 1.5)][2:] \
        == [1.3, 0.5]


def test_forward_flops_against_the_published_count():
    """The shgan_g512 forward is 240.4 GFLOP an image by XLA's cost
    analysis of the same forward (the JAX package's baseline record),
    which also counts the elementwise work (~1 %); the benchmark's count
    of the convolutions and dense layers is within 3 % of it."""
    f = work.generator_flops(G512["model"])
    assert abs(f / 240.4e9 - 1) < 0.03
    assert f < 240.4e9


def test_kernel_work_counts():
    """K2's and the epilogue's least time at shgan_g512 batch 8 against
    the bounds the port's smoke harness printed (1.25 and 1.23 ms)."""
    kind = "NVIDIA H100 80GB HBM3"
    k2 = work.least_ms(*work.fir_work(G512["model"], 8), kind)
    ep = work.least_ms(*work.epilogue_work(G512["model"], 8), kind)
    assert abs(k2 - 1.25) < 0.01 and abs(ep - 1.23) < 0.01
    assert work.peaks("cpu") is None
    per_img = work.train_flops_per_image(TRAIN)
    fg = work.generator_flops(TRAIN["model_g"])
    fd = work.discriminator_flops(TRAIN["model_d"]["args"])
    assert 4 * fg + 8 * fd < per_img < 5 * fg + 9 * fd


def test_peak_follows_the_stated_precision():
    """mfu divides by the rate the configuration's precision can reach:
    float32 without TF32 (training) the CUDA cores' rate, with TF32
    (serving) the tensor cores' TF32 rate."""
    kind = "NVIDIA H100 80GB HBM3"
    assert TRAIN["tf32"] is False and G512["tf32"] is True
    assert work.peak_flops(kind, TRAIN) == work.PEAKS[kind]["fp32_flops"]
    assert work.peak_flops(kind, G512) == work.PEAKS[kind]["tf32_flops"]
    assert work.peak_flops("cpu", G512) is None


def test_trace_reduction():
    dev = [(10, 20, "void upfirdn2d_tile_kernel"), (15, 30, "sm90_xmma_fprop"),
           (50, 60, "noise_bias_act_kernel"), (90, 200, "late")]
    spans = [("bench.window", 0, 100), ("bench.request", 5, 45),
             ("Gmain", 40, 80), ("bench.request", 46, 99)]
    t = Trace(dev, spans)
    assert t.window_s == 100e-6
    assert math.isclose(t.busy_s, (20 + 10 + 10) * 1e-6)
    assert t.busy_in(5, 45) == 20
    assert t.seconds_of("upfirdn2d") == 10e-6
    gaps = t.idle_gaps()
    # busy [10, 30], [50, 60], [90, 100]: the gaps [60, 90] (inside the
    # second request), [30, 50] and [0, 10] (inside no span but the window)
    assert [g[0] for g in gaps] == ["bench.request", "bench.window",
                                    "bench.window"]
    assert math.isclose(gaps[0][1], 30e-6)
    assert group_of("void upfirdn2d_tile_kernel") == "upfirdn2d (K2)"
    assert group_of("noise_bias_act_grad_kernel").startswith(
        "noise_bias_act_grad")
    b = t.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tiny-stream", "tiny-interactive",
                                  "tiny-train"])
def test_reference_agrees_with_the_port_on_the_cpu(tmp_path, one_thread,
                                                   name):
    """The plain reference against the port's CPU path at a tiny channel
    plan, through a whole run of each driver: the served composites agree
    to the uint8 level (no pixel off by more than one, none kept changed),
    the training step's losses, first gradients and three steps' changes
    to float32 round-off."""
    root, manifest = tiny.tree(tmp_path)
    cell = runner.Cell(manifest, name, 2 ** 31 + 41, 1.0, 0,
                       torch.device("cpu"), root=root)
    r = runner.execute(cell, log=lambda s: None)
    assert r["correct"] is True, r["checks"]
    if name == "tiny-train":
        assert r["checks"]["loss_gap"]["value"] < 1e-5
        assert r["checks"]["grad_gap"]["value"] < 1e-4
    else:
        assert r["checks"]["hole_px_off_pct"]["value"] == 0.0
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"] and all(m["value"] > 0 for m in r["metrics"].values())
