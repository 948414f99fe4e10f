"""bias_lrelu_roofline.stream on the CPU: the encoder's conv-output
elements counted from the two serving configurations, and the reader on
hand-built traces (the share, the fused epilogue's kernels left out,
nothing to read without a bias_lrelu kernel)."""

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

from harness import runner  # noqa: E402
from harness.trace import Trace  # noqa: E402

MANIFEST = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
KIND = "NVIDIA H100 80GB HBM3"
NAME = "bias_lrelu_roofline.stream"


def _config(name):
    return json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())


def _reader():
    return runner.load_module(tiny.BENCH / "metrics" / f"{NAME}.py",
                              "m_bias_lrelu_roofline")


@pytest.mark.parametrize("config,elements", [("shgan_g512", 64_307_200),
                                             ("shgan_g1024", 131_416_064)])
def test_encoder_conv_elements_hand_count(config, elements):
    """fromrgb, conv0 and conv1 of each level, the 4² conv: 16 convs at
    512², 18 at 1024², as the port's encoder builds them."""
    model = _config(config)["model"]
    assert _reader().encoder_conv_elements(model) == elements
    from shgan_torch.models.registry import get_model
    small = json.loads(json.dumps(model))
    res = small["args"]["encoder"]["args"]["resolution"]
    small["args"]["encoder"]["args"].update(ch_base=4 * res, ch_max=8,
                                            shu_channels=2)
    enc = get_model(small).encoder
    outs = []
    for m in enc.modules():
        if type(m).__name__ == "Conv2dLayer":
            outs.append(m.weight.shape[0])
    assert len(outs) == (16 if res == 512 else 18)
    assert _reader().encoder_conv_elements(small) == sum(
        c * r * r for c, r in zip(outs, _out_res(enc)))


def _out_res(enc):
    """The output resolution of each Conv2dLayer, in module order."""
    out = []
    for name, m in enc.named_modules():
        if type(m).__name__ != "Conv2dLayer":
            continue
        block = name.split(".")[0]
        r = int(block[1:])
        out.append(r // 2 if name.endswith("conv1") else r)
    return out


def _trace(kernels):
    return Trace(kernels, [("bench.window", 0.0, 100e3)])


def test_reader_gives_the_share_and_leaves_the_fused_epilogue_out():
    """Three batches of 8 at shgan_g512: bias_lrelu kernels of 1.5 ms a
    batch among the fused epilogue's and its grad kernel's (also in the
    window): the least time of the three over 4.5 ms."""
    cfg = _config("shgan_g512")
    ker = []
    for b in range(3):
        t0 = b * 30e3
        ker += [(t0, t0 + 1e3, "void (anonymous namespace)::bias_lrelu_"
                 "kernel<float, 4>(float const*, float*, "
                 "shgan::nba::BiasLaunch, float const*, shgan::nba::Act)"),
                (t0 + 1e3, t0 + 3e3, "void (anonymous namespace)::"
                 "noise_bias_act_kernel<float, 2>(float const*, float*)"),
                (t0 + 3e3, t0 + 4e3, "noise_bias_act_grad_kernel"),
                (t0 + 4e3, t0 + 4.5e3, "bias_lrelu_kernel<float, 2>")]
    cell = SimpleNamespace(config=cfg)
    run = runner.Run(cell, {"batches": [8, 8, 8]}, _trace(ker), KIND)
    least = 3 * 8 * 8 * 64_307_200 / 3.35e12 * 1e3
    got = _reader().read(run)
    assert math.isclose(got, 100.0 * least / 4.5)
    assert 80 < got < 85


def test_reader_reads_nothing_without_its_kernel():
    """No bias_lrelu kernel (the parent's PyTorch chain), no trace, no
    batch, a card not known: None."""
    cfg = _config("shgan_g1024")
    cell = SimpleNamespace(config=cfg)
    ker = [(0.0, 2e3, "noise_bias_act_kernel"),
           (2e3, 3e3, "vectorized_elementwise_kernel")]
    full = ker + [(3e3, 5e3, "bias_lrelu_kernel<float, 4>")]
    for r in (runner.Run(cell, {"batches": [8]}, _trace(ker), KIND),
              runner.Run(cell, {"batches": [8]}, None, KIND),
              runner.Run(cell, {"batches": []}, _trace(full), KIND),
              runner.Run(cell, {"batches": [8]}, _trace(full), "cpu")):
        assert _reader().read(r) is None
    assert _reader().read(runner.Run(cell, {"batches": [8]}, _trace(full),
                                     KIND)) > 0

