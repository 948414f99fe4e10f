"""The port's train stage and CLI on the CPU: ``TrainPipeline`` against
shgan_tpu's, the stage's resume against an uninterrupted run, and
``python -m shgan_torch.main --experiment smoke_train --device cpu``:
ten steps, snapshots, a resume that continues the step count, and the
exported G_ema ``.pth`` loaded by the port's eval stage."""

import copy
import glob
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from shgan_tpu.data.datasets import get_dataset as jax_get_dataset
from shgan_tpu.data.formatters import get_formatter as jax_get_formatter
from shgan_tpu.data.pipeline import TrainPipeline as JaxTrainPipeline
from shgan_torch.checkpoint.train_state import G_EMA_FILE, STATE_FILE
from shgan_torch.data.datasets import get_dataset
from shgan_torch.data.formatters import get_formatter
from shgan_torch.data.pipeline import TrainPipeline
from shgan_torch.main import build_config, run
from shgan_torch.runtime.stages import eval_stage
from test_torch_models import REPO

DS = {"type": "synthetic", "name": "synthetic32", "resolution": 32,
      "length": 10, "formatter": {"type": "RandomMaskFormatter",
                                  "args": {"random_flip": True,
                                           "mask_resolution": 32}}}


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_train_pipeline_matches_jax_across_epochs():
    """Batches of 4 from 10 images: 2 an epoch (drop_last), reshuffled with
    seed + epoch; five batches cross two epoch boundaries."""
    jp = JaxTrainPipeline(jax_get_dataset(DS),
                          jax_get_formatter(DS["formatter"]), 4, seed=3,
                          num_threads=0)
    tp = TrainPipeline(get_dataset(DS), get_formatter(DS["formatter"]), 4,
                       seed=3, num_threads=0)
    want, got = _take(iter(jp), 5), _take(iter(tp), 5)
    for (wr, wm), (gr, gm) in zip(want, got):
        np.testing.assert_array_equal(gr, np.asarray(wr))
        np.testing.assert_array_equal(gm, np.asarray(wm))
    assert not np.array_equal(got[0][0], got[2][0])   # a new order


def test_train_pipeline_start_and_device():
    """``start`` skips into the stream (across an epoch boundary); with a
    device the batches are tensors there, threads or not."""
    ds, fmt = get_dataset(DS), get_formatter(DS["formatter"])
    ref = _take(iter(TrainPipeline(ds, fmt, 4, seed=1, num_threads=0)), 6)
    got = _take(iter(TrainPipeline(ds, fmt, 4, seed=1, num_threads=2,
                                   start=3, device="cpu")), 3)
    for (wr, wm), (gr, gm) in zip(ref[3:], got):
        assert isinstance(gr, torch.Tensor) and gr.device.type == "cpu"
        np.testing.assert_array_equal(gr.numpy(), wr)
        np.testing.assert_array_equal(gm.numpy(), wm)
    with pytest.raises(ValueError, match="no batch"):
        next(iter(TrainPipeline(ds, fmt, 16, num_threads=0)))


def _smoke(tmp_path, total_kimg, **kw):
    return build_config("smoke_train", log_root=str(tmp_path),
                        overrides={"train.experiment_id": 0,
                                   "train.total_kimg": total_kimg}, **kw)


def test_resumed_run_equals_the_uninterrupted_run(tmp_path):
    """Three steps, a snapshot, three more from it (the path-length penalty
    at step 4): the same parameters, bit for bit, as six steps in one run
    (the per-step draws and the data stream are functions of the step)."""
    whole = run(_smoke(tmp_path / "a", 0.048), device="cpu")["step"]
    first = run(_smoke(tmp_path / "b", 0.024), device="cpu")
    assert first["step"].step == 3
    snap = glob.glob(str(tmp_path / "b" / "**" / "network-snapshot-*"),
                     recursive=True)
    assert len(snap) == 1
    rest = run(_smoke(tmp_path / "c", 0.048, resume_path=snap[0]),
               device="cpu")["step"]
    assert rest.step == whole.step == 6
    for a, b in ((whole.G, rest.G), (whole.D, rest.D),
                 (whole.G_ema, rest.G_ema)):
        for (name, x), (_, y) in zip(a.state_dict().items(),
                                     b.state_dict().items()):
            assert torch.equal(x, y), name
    assert torch.equal(whole.pl_mean, rest.pl_mean)


def _cli(args, tmp_path, code=None):
    env = dict(os.environ, SHGAN_LOG_ROOT=str(tmp_path))
    if code is None:
        cmd = [sys.executable, "-m", "shgan_torch.main", *args]
    else:
        cmd = [sys.executable, "-c", code, *args]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


def _steps(run_dir):
    sd = torch.load(osp.join(run_dir, "weight", "network-snapshot-000000",
                             STATE_FILE), weights_only=True)
    return sd["step"]


def test_cli_trains_snapshots_resumes_and_exports(tmp_path):
    # the first run, in an interpreter that must not import JAX
    code = ("import sys\n"
            "import shgan_torch.main as m\n"
            "m.main(sys.argv[1:])\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'shgan_tpu'))\n"
            "sys.exit(1 if bad else 0)\n")
    r = _cli(["--experiment", "smoke_train", "--device", "cpu"], tmp_path,
             code)
    assert r.returncode == 0, r.stdout + r.stderr
    run_dirs = glob.glob(str(tmp_path / "shgan_synthetic32" / "*" / "train"))
    assert len(run_dirs) == 1
    run_dir = run_dirs[0]
    log = open(osp.join(run_dir, "train.log")).read()
    assert log.count("saved snapshot") == 6 and "tick 9 " in log
    ticks = [json.loads(line) for line in open(osp.join(run_dir,
                                                        "stats.jsonl"))]
    assert len(ticks) == 10 and all(np.isfinite(t["loss_g"])
                                    and np.isfinite(t["loss_d"])
                                    for t in ticks)
    assert ticks[0]["pl_mean"] > 0 and ticks[0]["r1_penalty"] > 0
    assert _steps(run_dir) == 10

    # --resume_path alone continues the run in its dir, from its config
    cfg_path = osp.join(run_dir, "config.yaml")
    cfg = yaml.safe_load(open(cfg_path))
    cfg["train"]["total_kimg"] = 0.12
    yaml.safe_dump(cfg, open(cfg_path, "w"), sort_keys=False)
    r = _cli(["--resume_path", run_dir, "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    log = open(osp.join(run_dir, "train.log")).read()
    assert "resumed from" in log and "at step 10" in log
    assert _steps(run_dir) == 15

    # the exported G_ema loads into the eval stage, strict
    pth = osp.join(run_dir, "weight", "network-snapshot-000000", G_EMA_FILE)
    ecfg = {"env": {"rnd_seed": 0}, "model_g": cfg["model_g"],
            "eval": {"dataset": dict(copy.deepcopy(DS), length=4),
                     "batch_size": 2, "dataset_num_workers": 0,
                     "pretrained_pth": pth, "strict_sd": True,
                     "evaluator": [{"type": "psnr"}, {"type": "ssim"}],
                     "log_dir": str(tmp_path / "eval"), "log_display": 5}}
    ecfg["eval"]["dataset"]["formatter"]["args"]["random_flip"] = False
    rv = eval_stage()(ecfg, device="cpu")
    assert np.isfinite(rv["eval_rv"]["psnr"])


def test_cli_flags_for_training(tmp_path):
    cfg = build_config("shgan_ffhq256_train", log_root=str(tmp_path),
                       dataset="synthetic256_inpainting",
                       resume_path="w", resume_itern=3)
    assert cfg["eval"]["dataset"]["type"] == "synthetic"   # kept, swapped
    assert cfg["train"]["resume_itern"] == 3
    assert cfg["train"]["dataset"]["type"] == "synthetic"
    assert cfg["train"]["log_dir"].endswith(osp.join("train"))
    cfg = build_config("shgan_ffhq256_train", log_root=str(tmp_path),
                       eval_id=1)
    assert "train" not in cfg and cfg["eval"]["experiment_id"] == 1
    with pytest.raises(SystemExit, match="no eval section"):
        build_config("shgan_ffhq256_train", log_root=str(tmp_path),
                     eval_id=1, trainonly=True)
    with pytest.raises(SystemExit, match="needs an eval run"):
        build_config("smoke_train", log_root=str(tmp_path), eval_tag="t")


def _count_launches(monkeypatch):
    """Counts of the calls where each kernel's wrapper would launch it on
    the card (K2 forward and derivative calls apart, the epilogue and its
    grad kernel in both modes), kept in the dict returned."""
    import importlib

    from shgan_torch.ops import noise_bias_act as nba
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
    counts = {}
    fir_any, on = fir._fir_any, nba._on

    def counted_fir(x, taps, up, down, pads, counter):
        counts[counter] = counts.get(counter, 0) + 1
        return fir_any(x, taps, up, down, pads, counter)

    def counted_on(x, cuda_fn, plain_fn):
        name = ("noise_bias_act" if plain_fn is nba.noise_bias_act_plain
                else "noise_bias_act_grad")
        fn = on(x, cuda_fn, plain_fn)

        def run(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(fir, "_fir_any", counted_fir)
    monkeypatch.setattr(nba, "_on", counted_on)
    return counts


@pytest.mark.parametrize("res", [32, 64])
def test_chip_smoke_launch_rule_counts_a_step(res, monkeypatch):
    """The launch counts chip_smoke.py checks on the card, worked out from
    the modules, against the calls a train step makes, counted here where
    each kernel's wrapper would launch it."""
    import importlib

    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    from shgan_torch.models import get_model
    from shgan_torch.train import TrainConfig, TrainStep
    from test_torch_models import tiny_cfg
    from test_torch_train_ops import tiny_d_cfg
    counts = _count_launches(monkeypatch)
    G, D = get_model(tiny_cfg(res)), get_model(tiny_d_cfg(res))
    step = TrainStep(G, D, TrainConfig())
    sites = smoke.train_sites(G, D)
    assert sites[3] == 2 * int(np.log2(res)) - 3
    g = torch.Generator().manual_seed(0)
    real = torch.rand(4, 3, res, res, generator=g) * 2 - 1
    mask = (torch.rand(4, 1, res, res, generator=g) > 0.5).float()
    for greg, dreg in [(True, True), (False, False), (True, False)]:
        counts.clear()
        step(real, mask, torch.Generator().manual_seed(1), 0.9, greg, dreg)
        want = smoke.expected_train_launches(*sites, greg, dreg)
        assert counts == {k: v for k, v in want.items() if v}, (greg, dreg)
    # the K2 call list the script checks has the modules' K2 call count
    calls = smoke.train_fir_calls(tiny_cfg(res), tiny_d_cfg(res), 8)
    assert len(calls) == sites[0] + sites[1] + sites[2]


def test_chip_smoke_counts_the_grids_apart(tmp_path, monkeypatch):
    """As chip_smoke.py counts a training run: the counts set to 0 as each
    step starts (``on_step_start``) and read as it ends (``on_step``), so a
    step holds its own launches and G_ema's image grids (before step 0, at
    the image tick after step 1, after the last step) hold
    ``GRID_FORWARDS`` G forwards each, outside the steps."""
    import importlib

    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    counts = _count_launches(monkeypatch)
    per_step, outside = [], []

    def on_step_start(i):
        outside.append(dict(counts))
        counts.clear()

    def on_step(i, metrics):
        per_step.append(dict(counts))
        counts.clear()

    cfg = build_config("smoke_train", log_root=str(tmp_path),
                       overrides={"train.experiment_id": 0,
                                  "train.total_kimg": 0.024})
    rv = run(cfg, device="cpu", on_step=on_step, on_step_start=on_step_start)
    outside.append(dict(counts))
    step = rv["step"]
    sites = smoke.train_sites(step.G, step.D)
    tc = step.cfg
    for i, got in enumerate(per_step):
        want = smoke.expected_train_launches(
            *sites, i % tc.g_reg_interval == 0, i % tc.d_reg_interval == 0)
        assert got == {k: v for k, v in want.items() if v}, i
    grid = {"upfirdn2d": smoke.GRID_FORWARDS * (sites[0] + sites[1]),
            "noise_bias_act": smoke.GRID_FORWARDS * sites[3]}
    assert outside == [grid, {}, grid, grid]
