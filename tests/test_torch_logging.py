"""The port's train log and training grids against shgan_tpu's:
``ScalarLogger`` records keyed and valued as JAX's, read by
``shgan_tpu/runtime/logmine.py``; a port training run's ``stats.jsonl``
and its ``demo/fakes*.png`` grids with the JAX stage's names and shapes."""

import glob
import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
from PIL import Image

from shgan_tpu.runtime import logmine
from shgan_tpu.runtime.logging import ScalarLogger as JaxScalarLogger
from shgan_tpu.runtime.stages import save_image_grid as jax_save_image_grid
from shgan_torch.main import build_config, run
from shgan_torch.runtime.logging import ScalarLogger

SCALARS = [  # (scalars, weight) of three accumulations, two flushes
    ({"loss_g": 0.75, "loss_d": 1.25, "pl_mean": 0.0}, 1.0),
    ({"loss_g": np.float32(0.5), "loss_d": 1.5, "r1_penalty": 3.0}, 2.0),
    ({"loss_g": -1.0, "scores_real": 0.125}, 0.5),
]


def _feed(logger):
    means = []
    for i, (scalars, weight) in enumerate(SCALARS):
        logger.accumulate(scalars, weight)
        if i in (1, 2):
            means.append(logger.flush(8 * (i + 1)))
    logger.close()
    return means


def _records(log_dir):
    return [json.loads(line) for line in open(osp.join(log_dir,
                                                       "stats.jsonl"))]


def test_scalar_logger_writes_jax_records(tmp_path):
    """The same scalars through both loggers: the same means returned, and
    records with the same keys and values but ``time``."""
    got = _feed(ScalarLogger(str(tmp_path / "torch")))
    want = _feed(JaxScalarLogger(str(tmp_path / "jax")))
    assert got == want
    a, b = _records(tmp_path / "torch"), _records(tmp_path / "jax")
    assert len(a) == len(b) == 2
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        assert isinstance(ra.pop("time"), float)
        rb.pop("time")
        assert ra == rb
    assert a[0]["step"] == 16 and a[0]["loss_g"] == pytest.approx(7 / 12)
    assert ScalarLogger(None).flush(3) == {}    # no log dir: no file


def test_scalar_logger_tensorboard_and_its_absence(tmp_path, monkeypatch,
                                                   capsys):
    """With ``tensorboard`` the means go to event files under
    ``<log_dir>/tensorboard``; where tensorboard does not import, the
    logger says so once and writes stats.jsonl alone."""
    logger = ScalarLogger(str(tmp_path / "tb"), tensorboard=True)
    _feed(logger)
    assert glob.glob(str(tmp_path / "tb" / "tensorboard" / "events.*"))
    import torch.utils
    monkeypatch.delattr(torch.utils, "tensorboard", raising=False)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = ScalarLogger(str(tmp_path / "none"), tensorboard=True)
    assert logger.tb is None
    assert "no events are written" in capsys.readouterr().out
    _feed(logger)
    assert len(_records(tmp_path / "none")) == 2
    assert not osp.exists(tmp_path / "none" / "tensorboard")


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """Three steps of ``smoke_train`` on the CPU, a grid every tick."""
    root = tmp_path_factory.mktemp("smoke")
    cfg = build_config("smoke_train", log_root=str(root),
                       overrides={"train.experiment_id": 0,
                                  "train.total_kimg": 0.024,
                                  "train.image_snapshot_ticks": 1})
    rv = run(cfg, device="cpu")
    return cfg["train"]["log_dir"], rv


def test_logmine_reads_a_port_run(smoke_run, tmp_path):
    """shgan_tpu's logmine reads the run's stats.jsonl: a record a tick,
    ``step`` the images seen, the stage's tick means beside it."""
    log_dir, rv = smoke_run
    records = logmine.load_stats(log_dir)
    assert [r["step"] for r in records] == [8, 16, 24]
    for r, tick in zip(records, rv["ticks"]):
        assert {k: r[k] for k in tick if k not in ("kimg", "tick")} == \
            {k: v for k, v in tick.items() if k not in ("kimg", "tick")}
        assert np.isfinite(r["loss_g"]) and np.isfinite(r["loss_d"])
    assert records[0]["r1_penalty"] > 0 and records[0]["pl_mean"] > 0
    out = logmine.plotter(log_dir, out_png=str(tmp_path / "curves.png"))
    assert osp.isfile(out)


def test_train_run_writes_the_jax_grids(smoke_run, tmp_path):
    """The run writes G_ema's grids as the JAX stage does: fakes_init.png
    before the first step, fakes<kimg>.png at every image tick and at the
    end, each with its _combined grid, and the masks / reals / erased
    grids; 8 x 6 tiles of the model's resolution, as JAX's
    save_image_grid makes them."""
    log_dir, _ = smoke_run
    demo = osp.join(log_dir, "demo")
    assert sorted(os.listdir(demo)) == sorted(
        ["fakes_init.png", "fakes_init_combined.png", "fakes000000.png",
         "fakes000000_combined.png", "masks.png", "reals.png", "erased.png"])
    res = 32
    jax_save_image_grid(np.zeros((48, 3, res, res), np.float32),
                        str(tmp_path / "rgb.png"), (-1, 1), (8, 6))
    jax_save_image_grid(np.zeros((48, 1, res, res), np.float32),
                        str(tmp_path / "mask.png"), (0, 1), (8, 6))
    for name in os.listdir(demo):
        ref = "mask.png" if name == "masks.png" else "rgb.png"
        got, want = Image.open(osp.join(demo, name)), Image.open(
            tmp_path / ref)
        assert (got.size, got.mode) == (want.size, want.mode), name
    fakes = np.asarray(Image.open(osp.join(demo, "fakes000000.png")))
    assert fakes.std() > 0
