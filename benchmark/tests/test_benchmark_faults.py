"""The check tells a broken timed path: each run drives the whole harness
on the CPU at a tiny size (skipping only the look for a card) with the
program broken underneath, and ``correct`` has to come out false."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from harness import runner  # noqa: E402


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, name):
    root, manifest = tiny.tree(tmp_path)
    cell = runner.Cell(manifest, name, 2 ** 31 + 17, 1.0, 0,
                       torch.device("cpu"), root=root)
    return runner.execute(cell, log=lambda s: None)


def _altered(out):
    """An answer altered where it is produced: one composite's hole
    pixels moved by a few levels."""
    out = out.copy()
    out[0, 0, ::4, ::4] = (out[0, 0, ::4, ::4].astype(np.int16) + 7).clip(
        0, 255).astype(np.uint8)
    return out


@pytest.mark.parametrize("name", ["tiny-stream", "tiny-interactive"])
def test_altered_answer_is_not_correct(tmp_path, one_thread, monkeypatch,
                                       name):
    from shgan_torch import serve
    inpaint, stream = serve.InpaintEngine.inpaint, \
        serve.InpaintEngine.inpaint_stream

    def bad_inpaint(self, *a, **k):
        return _altered(inpaint(self, *a, **k))

    def bad_stream(self, *a, **k):
        for out in stream(self, *a, **k):
            yield _altered(out)

    monkeypatch.setattr(serve.InpaintEngine, "inpaint", bad_inpaint)
    monkeypatch.setattr(serve.InpaintEngine, "inpaint_stream", bad_stream)
    assert _run(tmp_path, name)["correct"] is False


def test_swapped_rows_are_not_correct(tmp_path, one_thread, monkeypatch):
    """Answers that come back in the wrong order are wrong answers."""
    from shgan_torch import serve
    inpaint = serve.InpaintEngine.inpaint

    def swapped(self, images, masks, start_index=0):
        return inpaint(self, images, masks, start_index + 1)

    monkeypatch.setattr(serve.InpaintEngine, "inpaint", swapped)
    assert _run(tmp_path, "tiny-interactive")["correct"] is False


def test_state_left_unchanged_is_not_correct(tmp_path, one_thread,
                                             monkeypatch):
    from shgan_torch.train import step as step_mod
    monkeypatch.setattr(step_mod, "optimizer_step", lambda opt, count: None)
    monkeypatch.setattr(step_mod, "ema_update", lambda *a: None)
    r = _run(tmp_path, "tiny-train")
    assert r["correct"] is False
    assert r["checks"]["change_gap"]["value"] > 0.5


def test_half_batch_is_not_correct(tmp_path, one_thread, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from shgan_torch.train import step as step_mod
    call = step_mod.TrainStep.__call__

    def half(self, real, mask, *a, **k):
        n = real.shape[0] // 2
        return call(self, real[:n], mask[:n], *a, **k)

    monkeypatch.setattr(step_mod.TrainStep, "__call__", half)
    assert _run(tmp_path, "tiny-train")["correct"] is False
