"""The train stage's nested eval, ``-best`` snapshots and profiler hook,
the port's log mining and the CLI's last flags, against shgan_tpu: the
scored images against JAX's nested-eval forward, psnr / ssim / fid over
them through both packages' evaluators, the eval schedule and the best
rule on a port run, the build-time checks, the profiler's trace, and
``logmine`` over a port run."""

import json
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from shgan_tpu.eval import base as jbase
from shgan_tpu.eval import feature_metrics as jfm
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.parallel import create_mesh
from shgan_tpu.runtime import logmine as jlogmine
from shgan_tpu.runtime.stages import train_stage as jax_train_stage
from shgan_torch import main as tmain
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.eval import base as tbase
from shgan_torch.eval import feature_metrics as tfm
from shgan_torch.main import build_config, run
from shgan_torch.models import get_model
from shgan_torch.runtime import logmine as tlogmine
from shgan_torch.models.infer import composite
from shgan_torch.runtime.stages import (is_improvement, make_nested_eval,
                                        nested_eval_views, next_eval_nimg)

from test_torch_metrics import _StandIn
from test_torch_models import tiny_cfg

RES = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny training runs here are launch-bound: one intra-op thread
    runs them as fast as eight, and keeps them fast while other test
    workers load every core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def stand_in(monkeypatch):
    det = _StandIn()
    for mod in (jfm, tfm):
        monkeypatch.setattr(mod, "get_detector", lambda *a, **k: det)
    return det


def _models(seed=0):
    """The JAX tiny generator and the port's with its weights, every
    ``noise_strength`` 0 (the two packages draw their noise by design
    differently)."""
    jG = jax_get_model(tiny_cfg(RES))
    params = jG.init(jax.random.key(seed))
    G = get_model(tiny_cfg(RES))
    G.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.zero_()
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 0 if path[-1].key == "noise_strength" else v,
        params)
    return jG, params, G.eval()


def _batch(n=8, seed=1):
    rng = np.random.RandomState(seed)
    real = rng.uniform(-1, 1, (n, 3, RES, RES)).astype(np.float32)
    mask = (rng.rand(n, 1, RES, RES) > 0.4).astype(np.float32)
    z = rng.randn(n, 32).astype(np.float32)
    return real, mask, z


def _jax_fwd(jG, params, real, mask, z):
    """JAX's nested-eval forward (``train_stage._make_nested_eval.fwd``)."""
    import jax.numpy as jnp

    @jax.jit
    def fwd(params, real, mask, z):
        x = jnp.concatenate([mask - 0.5, real * mask], axis=1)
        img = jG(params, x, z, noise_mode="random", rng=jax.random.key(7))
        combined = real * mask + img * (1 - mask)
        return jnp.clip(combined * 127.5 + 127.5, 0, 255)
    return np.asarray(fwd(params, real, mask, z))


def test_scored_images_match_jax():
    """The same z, weights and batch: the uint8 values of the nested
    eval's scored images (``models.infer.composite`` with random noise)
    agree on ≥ 99.9 % of the values and by ≤ 1 everywhere."""
    jG, params, G = _models()
    real, mask, z = _batch()
    want = np.rint(_jax_fwd(jG, params, real, mask, z)).astype(np.int32)
    with torch.inference_mode():
        got = composite(G, torch.from_numpy(real), torch.from_numpy(mask),
                        torch.from_numpy(z), "random", noise_seed=5)
    got = torch.round(got).numpy().astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (
        diff.max(), (diff == 0).mean())


@pytest.mark.parametrize("metric", ["psnr", "ssim", "fid"])
def test_scores_match_jax(metric, stand_in, tmp_path):
    """Two batches of the same scored images (fid's quantized with rint)
    through JAX's ``add_batch`` formulas and the port's nested-eval views:
    the metric within 1e-5 relative (fid on the stand-in detector, its
    real features cached by each package's first pass)."""
    jG, params, _ = _models()
    args = ({"cache_dir": str(tmp_path), "dsstat_cachefile_tag": "nested8",
             "sample_real_n": None, "sample_fake_n": None}
            if metric == "fid" else {})
    jev = jbase.get_evaluator([{"type": metric, "args": args}])
    targs = dict(args, cache_dir=str(tmp_path / "t")) if args else {}
    tev = tbase.get_evaluator([{"type": metric, "args": targs}])
    for b in range(2):
        real, mask, z = _batch(seed=b)
        fake = _jax_fwd(jG, params, real, mask, z)
        if metric == "fid":
            fake = np.rint(fake)
        valid = np.array([True] * 7 + [b == 0])
        jev.add_batch(pred=fake / 255.0, gt=(real + 1) / 2, fake=fake,
                      real=real * 127.5 + 127.5, fn=None, valid=valid)
        tev.add_batch(fn=None, valid=valid, **nested_eval_views(
            torch.from_numpy(fake), torch.from_numpy(real),
            tev.consumes_host_pixels))
    for ev in (jev, tev):
        ev.set_sample_n(15)
    want, got = jev.compute()[metric], tev.compute()[metric]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _train_cfg(tmp_path, tag, **train):
    """smoke_train (tiny 32² SH-GAN, batch 8) with a psnr nested eval over
    the first 8 images of its dataset at batch 4."""
    cfg = build_config("smoke_train", log_root=str(tmp_path / tag),
                       overrides={"train.experiment_id": 0})
    cfg["train"].update(image_snapshot_ticks=0, **train)
    cfg["eval"] = {"dataset": dict(cfg["train"]["dataset"]), "batch_size": 4,
                   "nested_eval_samples": 8}
    return cfg


def _stats(cfg):
    with open(osp.join(cfg["train"]["log_dir"], "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_eval_schedule_best_and_resume(tmp_path):
    """Ticks of 3 steps (24 images) and an eval every 16: one eval a tick
    whichever intervals it crossed (at 24, 48, 72), its ``eval_psnr`` in
    that tick's record; each strict improvement logs ``new best`` and
    writes ``network-snapshot-best``.  A run resumed from the last
    snapshot (72 images) with an eval every 48 rebases to 96: an eval at
    its first tick (96), none at its second (120), and its best starts
    anew."""
    assert [next_eval_nimg(n, 0.016) for n in (0, 15, 16, 40, 48)] == \
        [16, 16, 32, 48, 64]
    assert is_improvement(1.0, None, True) and is_improvement(1.0, None,
                                                              False)
    assert is_improvement(2.0, 1.0, True) and not is_improvement(1.0, 1.0,
                                                                 True)
    assert is_improvement(0.5, 1.0, False) and not is_improvement(
        2.0, 1.0, False)
    cfg = _train_cfg(tmp_path, "a", total_kimg=0.072, kimg_per_tick=0.024,
                     eval_every_kimg=0.016, snapshot_ticks=2)
    rv = run(cfg, device="cpu")
    assert rv["step"].step == 9 and len(rv["timing"]["nested_eval_s"]) == 3
    stats = _stats(cfg)
    assert [r["step"] for r in stats] == [24, 48, 72]
    vals = [r["eval_psnr"] for r in stats]
    log = open(osp.join(cfg["train"]["log_dir"], "train.log")).read()
    best, n_best = None, 0
    for v in vals:
        if is_improvement(v, best, True):
            best, n_best = v, n_best + 1
    assert log.count("new best psnr=") == n_best >= 1
    weight = osp.join(cfg["train"]["log_dir"], "weight")
    assert "network-snapshot-best" in os.listdir(weight)
    # resume from the last snapshot (72 images) and run to 120
    cfg2 = _train_cfg(tmp_path, "b", total_kimg=0.12, kimg_per_tick=0.024,
                      eval_every_kimg=0.048, snapshot_ticks=100,
                      resume_path=osp.join(weight,
                                           "network-snapshot-000000"))
    rv2 = run(cfg2, device="cpu")
    assert rv2["step"].step == 15
    stats2 = _stats(cfg2)
    assert [r["step"] for r in stats2] == [96, 120]
    assert ["eval_psnr" in r for r in stats2] == [True, False]
    log2 = open(osp.join(cfg2["train"]["log_dir"], "train.log")).read()
    assert log2.count("new best psnr=") == 1   # best starts anew


def test_build_time_checks_match_jax(tmp_path, monkeypatch, capsys):
    """``is`` refused at build time with JAX's message; fid without
    detector weights falls back to psnr with one log line, in both."""
    monkeypatch.delenv("SHGAN_TPU_INCEPTION", raising=False)
    cfg = _train_cfg(tmp_path, "c")
    cfg["env"]["debug"] = True
    G = get_model(cfg["model_g"])
    jG = jax_get_model(cfg["model_g"])
    mesh = create_mesh(1)
    cfg["eval"]["nested_eval_metric"] = "is"
    with pytest.raises(ValueError) as te:
        make_nested_eval(cfg, G, "cpu")
    with pytest.raises(ValueError) as je:
        jax_train_stage._make_nested_eval(cfg, cfg["env"], jG, mesh)
    assert str(te.value) == str(je.value)
    cfg["eval"]["nested_eval_metric"] = "fid"
    capsys.readouterr()
    name, value, higher = make_nested_eval(cfg, G, "cpu")(G)
    out = capsys.readouterr().out
    assert (name, higher) == ("psnr", True) and np.isfinite(value)
    assert out.count("falling back to psnr") == 1
    jname, _, jhigher = jax_train_stage._make_nested_eval(
        cfg, cfg["env"], jG, mesh)(jG.init(jax.random.key(0)))
    assert (jname, jhigher) == (name, higher)


@pytest.mark.parametrize("source", ["config", "env"])
def test_profiler_traces_steps_8_to_10(tmp_path, monkeypatch, source):
    """``train.profile_dir`` or ``SHGAN_PROFILE_DIR``: one Chrome trace of
    steps 8, 9 and 10, each phase a span (three Gmain, three Dmain)."""
    prof = str(tmp_path / "prof")
    cfg = build_config("smoke_train", log_root=str(tmp_path),
                       overrides={"train.experiment_id": 0,
                                  "train.total_kimg": 0.096,
                                  "train.image_snapshot_ticks": 0})
    if source == "config":
        cfg["train"]["profile_dir"] = prof
    else:
        monkeypatch.setenv("SHGAN_PROFILE_DIR", prof)
    run(cfg, device="cpu")
    assert os.listdir(prof) == ["train_steps000008-000010.json"]
    with open(osp.join(prof, "train_steps000008-000010.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("Gmain") == 3 and spans.count("Dmain") == 3
    assert spans.count("Gpl") == 1    # step 8
    log = open(osp.join(cfg["train"]["log_dir"], "train.log")).read()
    assert "wrote profiler trace to" in log


def test_logmine_matches_jax_on_a_port_run(tmp_path):
    """``gather_result``, ``format_result_table`` and ``load_stats`` of
    both packages over a log tree holding a port training run with
    ``eval_psnr`` records and a port eval's ``result.json``."""
    cfg = _train_cfg(tmp_path, "log", total_kimg=0.048,
                     kimg_per_tick=0.024, eval_every_kimg=0.024)
    run(cfg, device="cpu")
    ecfg = build_config("smoke_train", log_root=str(tmp_path / "log"),
                        overrides={"train.experiment_id": 1})
    ecfg["eval"] = {"dataset": dict(ecfg["train"]["dataset"]),
                    "batch_size": 4, "log_dir": osp.join(
                        str(tmp_path / "log"), "eval_run"),
                    "evaluator": [{"type": "psnr"}, {"type": "ssim"}],
                    "dataset_num_workers": 0}
    ecfg.pop("train")
    ecfg["env"]["mesh_devices"] = 1
    ecfg["eval"]["dataset"]["length"] = 4
    run(ecfg, device="cpu")
    root = str(tmp_path / "log")
    got = tlogmine.gather_result(root)
    assert got == jlogmine.gather_result(root) and len(got) == 1
    assert tlogmine.format_result_table(got) == \
        jlogmine.format_result_table(got)
    keys = ["psnr.psnr"]
    assert tlogmine.gather_result(root, keys) == \
        jlogmine.gather_result(root, keys)
    d = cfg["train"]["log_dir"]
    assert tlogmine.load_stats(d) == jlogmine.load_stats(d)
    assert all("eval_psnr" in r for r in tlogmine.load_stats(d))


def test_cli_signature_dscache_port_and_code_snapshot(tmp_path,
                                                      monkeypatch):
    """``--signature a b`` suffixes the run id, ``--dscache`` (bare or with
    a value) caches both sections' datasets, ``--port`` is accepted; outside ``--debug`` the log
    dir gets ``code/shgan_torch`` and ``code/configs``, and
    ``env.code_snapshot: false`` (smoke_train's) or ``--debug`` skip it.
    The stage itself is not run here."""
    monkeypatch.setenv("SHGAN_LOG_ROOT", str(tmp_path))
    seen = []
    monkeypatch.setattr(tmain, "run", lambda cfg, device=None: seen.append(
        cfg))
    tmain.main(["--experiment", "shgan_ffhq256_train", "--signature", "a",
                "b", "--dscache", "--port", "1234", "--device", "cpu"])
    cfg = seen[-1]
    log_dir = cfg["train"]["log_dir"]
    assert osp.basename(osp.dirname(log_dir)).endswith("_a_b")
    assert cfg["train"]["dataset"]["cache"] is True
    assert cfg["eval"]["dataset"]["cache"] is True
    # the JAX CLI's form (main.py:44, type=str): --dscache with a value
    tmain.main(["--experiment", "shgan_ffhq256_train", "--debug",
                "--dscache", "1", "--device", "cpu"])
    assert seen[-1]["train"]["dataset"]["cache"] is True
    assert seen[-1]["eval"]["dataset"]["cache"] is True
    code = osp.join(log_dir, "code")
    assert sorted(os.listdir(code)) == ["configs", "shgan_torch"]
    assert osp.isfile(osp.join(code, "shgan_torch", "train",
                               "schedules.py"))
    assert not any("__pycache__" in d for d, _, _ in os.walk(code))
    for argv in (["--experiment", "smoke_train"],
                 ["--experiment", "shgan_ffhq256_train", "--debug"]):
        tmain.main(argv + ["--device", "cpu"])
        assert not osp.exists(osp.join(seen[-1]["train"]["log_dir"],
                                       "code"))


def test_new_modules_leave_jax_out():
    """A fresh interpreter imports the schedules, the snapshot reader, the
    ``.pth`` writer and exporter, the log mining and the utils, and builds
    a schedule and an optimizer, without importing jax or shgan_tpu."""
    import subprocess
    import sys
    from test_torch_models import REPO
    code = (
        "import sys, torch\n"
        "import shgan_torch\n"
        "from shgan_torch.train import get_optimizer, get_scheduler\n"
        "from shgan_torch.checkpoint import (load_network_snapshot,\n"
        "    save_torch_pth, tf_params_to_torch_state_dict)\n"
        "from shgan_torch import export_pth\n"
        "from shgan_torch.runtime import logmine, stages\n"
        "from shgan_torch.utils import device_timeit\n"
        "s = get_scheduler([{'type': 'poly', 'args': {'start_lr': 1.0,\n"
        "    'end_lr': 0.0, 'power': 2, 'step': 4}}])\n"
        "opt = get_optimizer({'type': 'sgd'}, [torch.nn.Parameter(\n"
        "    torch.zeros(1))], s)\n"
        "assert opt.lr_at(2) == 0.25\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'shgan_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
