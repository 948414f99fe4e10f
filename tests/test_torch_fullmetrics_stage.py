"""The published eval protocol in the port: the composed evaluators of
``shgan_ffhq256_fullmetrics_eval`` against JAX's on identical batches, the
port's eval stage on a tiny FFHQ zip with every evaluator (PPL driving the
generator after the stream), the pre-generated path against JAX's
``_eval_pregen``, and ``--evalnog_path``'s three dataset rewrites against
JAX's CLI.  Both packages' feature metrics read one stand-in detector
(tests/test_torch_eval.py holds Inception itself to the golden fixture)."""

import copy
import json
import os
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

import shgan_tpu.eval  # noqa: F401  (registers JAX's evaluators)
from shgan_tpu.eval import base as jbase
from shgan_tpu.eval import feature_metrics as jfm
from shgan_tpu.eval.lpips import random_lpips_params as j_random_lpips
from shgan_tpu.runtime import config as jconfig
from shgan_tpu.runtime import stages as jstages
from shgan_torch.eval import base as tbase
from shgan_torch.eval import feature_metrics as tfm
from shgan_torch.main import build_config, set_evalnog_path
from shgan_torch.runtime.stages import eval_stage

from test_torch_datasets import real_png_decoder  # noqa: F401  (autouse)
from test_torch_metrics import _StandIn
from test_torch_models import REPO, tiny_cfg

RES, N_IMAGES, BATCH = 32, 8, 4
TOL = {"fid": 1e-9, "kid": 1e-9, "lpips": 1e-5, "psnr": 1e-9, "ssim": 1e-5}


@pytest.fixture()
def stand_in(monkeypatch):
    det = _StandIn()
    for mod in (jfm, tfm):
        monkeypatch.setattr(mod, "get_detector", lambda *a, **k: det)
    return det


@pytest.fixture(scope="module")
def lpips_params():
    import jax
    return jax.tree_util.tree_map(np.asarray,
                                  j_random_lpips(jax.random.key(0)))


def _evaluators(cache_dir, lpips_params, with_ppl=False):
    """The evaluator list of ``shgan_ffhq256_fullmetrics_eval``, its
    protocol sizes cut to 8 images, the LPIPS weights in memory."""
    cfg = copy.deepcopy(jconfig.experiment_cfg_bank()(
        "shgan_ffhq256_fullmetrics_eval")["eval"]["evaluator"])
    out = []
    for c in cfg:
        args = dict(c.get("args") or {})
        if c["type"] in ("fid", "kid", "pr", "is"):
            args["cache_dir"] = str(cache_dir)
        if c["type"] == "kid":
            args.update(num_subsets=5, max_subset_size=6)
        if c["type"] == "is":
            args["num_splits"] = 2
        if c["type"] == "lpips":
            args["params"] = lpips_params
        if c["type"] == "ppl":
            if not with_ppl:
                continue
            args.update(num_samples=8, batch_size=4, net="alex",
                        lpips_params=lpips_params)
        out.append({"type": c["type"], "args": args})
    return out


def _close(t, j, keys=None):
    for k in keys or TOL:
        if k not in j:
            continue
        assert t[k] == pytest.approx(j[k], rel=TOL[k]), k
    assert t["pr"] == j["pr"] and t["is"] == j["is"]


def test_composed_evaluators_match_jax(tmp_path, stand_in, lpips_params):
    """fid, kid, pr, is, lpips, psnr and ssim on the same host batches."""
    evs = {p: base.get_evaluator(_evaluators(tmp_path / p, lpips_params))
           for p, base in (("jax", jbase), ("torch", tbase))}
    rng = np.random.RandomState(3)
    for b in range(2):
        fake = rng.randint(0, 256, (4, 3, RES, RES)).astype(np.float32)
        real = rng.randint(0, 256, (4, 3, RES, RES)).astype(np.float32)
        valid = np.array([True, True, True, b == 0])
        for ev in evs.values():
            ev.add_batch(fake=fake, real=real, pred=fake / 255.0,
                         gt=real / 255.0, valid=valid)
    rv = {}
    for p, ev in evs.items():
        ev.set_sample_n(7)
        rv[p] = ev.compute()
    assert set(rv["torch"]) == set(rv["jax"]) == {
        "fid", "kid", "pr", "is", "lpips", "psnr", "ssim"}
    _close(rv["torch"], rv["jax"])


def _ffhq_zip(root, n=N_IMAGES, seed=0):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    with zipfile.ZipFile(os.path.join(root, "ffhq256x256.zip"), "w") as z:
        for i in range(n):
            img = Image.fromarray(rng.randint(0, 256, (RES, RES, 3),
                                              np.uint8))
            p = os.path.join(root, "tmp.png")
            img.save(p)
            z.write(p, f"{i:05d}.png")
    return root


def _fullmetrics_cfg(tmp_path, lpips_params, tag):
    cfg = build_config("shgan_ffhq256_fullmetrics_eval", eval_id=0,
                       log_root=str(tmp_path / tag))
    cfg["model_g"] = tiny_cfg(RES)
    ev = cfg["eval"]
    ev["dataset"]["root_dir"] = _ffhq_zip(str(tmp_path / "ffhq"))
    ev["dataset"]["formatter"]["args"]["mask_resolution"] = RES
    ev.update(batch_size=BATCH, dataset_num_workers=2, pretrained_pth=None,
              evaluator=_evaluators(tmp_path / "cache", lpips_params,
                                    with_ppl=True))
    return cfg


def test_fullmetrics_stage_runs_every_evaluator(tmp_path, stand_in,
                                                lpips_params):
    cfg = _fullmetrics_cfg(tmp_path, lpips_params, "a")
    rv = eval_stage()(cfg, device="cpu")
    t = rv["eval_rv"]
    assert set(t) == {"fid", "kid", "pr", "is", "ppl", "lpips", "psnr",
                      "ssim"}
    vals = [t["fid"], t["kid"], t["pr"]["precision"], t["pr"]["recall"],
            t["is"]["is_mean"], t["is"]["is_std"], t["ppl"], t["lpips"],
            t["psnr"], t["ssim"]]
    assert np.isfinite(vals).all() and t["ppl"] > 0
    assert rv["timing"]["generator_metrics_s"] > 0
    with open(os.path.join(cfg["eval"]["log_dir"], "result.json")) as f:
        saved = json.load(f)
    assert saved["ppl"]["ppl"] == t["ppl"]
    assert saved["is"]["is_mean"] == t["is"]["is_mean"]
    # again with the real-feature cache written by the first run
    cached = tmp_path / "cache" / "ffhqzip_val256_inpainting_ts_real_feat.npy"
    assert cached.is_file()
    calls = stand_in.calls
    rv2 = eval_stage()(_fullmetrics_cfg(tmp_path, lpips_params, "b"),
                       device="cpu")["eval_rv"]
    assert stand_in.calls - calls < calls     # no real features this time
    for k in ("fid", "kid", "pr", "is", "ppl", "lpips", "psnr", "ssim"):
        assert rv2[k] == t[k], k


def _gen_dir(root, seed=9):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(N_IMAGES):
        Image.fromarray(rng.randint(0, 256, (RES, RES, 3), np.uint8)).save(
            os.path.join(root, f"{i:05d}.png"))
    return root


def test_pregen_matches_jax(tmp_path, stand_in, lpips_params):
    root = _ffhq_zip(str(tmp_path / "ffhq"))
    gen = _gen_dir(str(tmp_path / "gen"))
    rv = {}
    for p, stage in (("jax", jstages.eval_stage()),
                     ("torch", eval_stage())):
        cfg = {"env": {"rnd_seed": 0, "mesh_devices": 1},
               "model_g": None,   # the generator never runs
               "eval": {"log_dir": str(tmp_path / p), "batch_size": 3,
                        "dataset_num_workers": 2, "log_display": 1,
                        "dataset": {"type": "ffhqzip_loadgen",
                                    "root_dir": root, "mode": "val256",
                                    "args": {"gen_dir": gen}},
                        "evaluator": _evaluators(tmp_path / p, lpips_params)}}
        kw = {"device": "cpu"} if p == "torch" else {}
        rv[p] = stage(cfg, **kw)["eval_rv"]
        with open(tmp_path / p / "result.json") as f:
            assert set(json.load(f)) == set(rv[p])
    _close(rv["torch"], rv["jax"])


def _jax_cli_dataset(monkeypatch, tmp_path, ds, gen):
    """The eval dataset dict JAX's ``main.py`` builds for ``ds`` under
    ``--evalnog_path gen`` (its stage replaced by a capture)."""
    import main as jmain
    from shgan_tpu.runtime import logging as jlog

    base = jconfig.experiment_cfg_bank()("shgan_ffhq256_eval")
    base["eval"]["dataset"] = copy.deepcopy(ds)
    base["env"]["code_snapshot"] = False
    monkeypatch.setattr(jconfig, "experiment_cfg_bank",
                        lambda: (lambda name: copy.deepcopy(base)))
    seen = {}

    class Capture:
        def __call__(self, cfg):
            seen["ds"] = cfg["eval"]["dataset"]

    monkeypatch.setattr(jstages, "eval_stage", Capture)
    monkeypatch.setenv("SHGAN_LOG_ROOT", str(tmp_path / "jcli"))
    monkeypatch.setattr(sys, "argv", ["main.py", "--experiment", "x",
                                      "--eval", "0",
                                      "--evalnog_path", gen])
    try:
        jmain.main()
    finally:
        jlog.set_log_file(None)
    return seen["ds"]


@pytest.mark.parametrize("shape", ["zip", "loadgen", "wrapped"])
def test_evalnog_path_builds_the_jax_dataset(shape, tmp_path, monkeypatch):
    bank = jconfig.dataset_cfg_bank()
    ds = {"zip": bank("ffhqzip_val256_inpainting"),
          "loadgen": dict(bank("ffhqzip_val256_inpainting"),
                          type="ffhqzip_loadgen"),
          "wrapped": bank("synthetic256_inpainting")}[shape]
    ds = json.loads(json.dumps(ds))
    gen = str(tmp_path / "gen")
    want = _jax_cli_dataset(monkeypatch, tmp_path, ds, gen)
    got = set_evalnog_path(copy.deepcopy(ds), gen)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["type"] == {"zip": "ffhqzip_loadgen",
                           "loadgen": "ffhqzip_loadgen",
                           "wrapped": "loadgen"}[shape]


def test_cli_evalnog_path_runs_the_pregen_stage(tmp_path):
    """``python -m shgan_torch.main --evalnog_path`` on the CPU: the
    experiment's ffhqzip dataset becomes ffhqzip_loadgen, no generator is
    built, and result.json holds the metrics."""
    import subprocess
    root = _ffhq_zip(str(tmp_path / "data" / "ffhq"))
    gen = _gen_dir(str(tmp_path / "gen"))
    cfg = build_config("shgan_ffhq256_eval", eval_id=0, evalnog_path=gen,
                       log_root=str(tmp_path / "log"))
    assert cfg["eval"]["dataset"]["type"] == "ffhqzip_loadgen"
    code = (
        "import sys\n"
        "from shgan_torch import main\n"
        "orig = main.build_config\n"
        "def patched(*a, **k):\n"
        "    cfg = orig(*a, **k)\n"
        f"    cfg['eval']['dataset']['root_dir'] = {root!r}\n"
        "    cfg['eval']['evaluator'] = [{'type': 'psnr'}, {'type': 'ssim'}]\n"
        "    return cfg\n"
        "main.build_config = patched\n"
        "main.main(sys.argv[1:])\n")
    env = dict(os.environ, SHGAN_LOG_ROOT=str(tmp_path / "cli"))
    r = subprocess.run(
        [sys.executable, "-c", code, "--experiment", "shgan_ffhq256_eval",
         "--eval", "0", "--evalnog_path", gen, "--pretrained",
         str(tmp_path / "absent.pth"), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    run_dir = (tmp_path / "cli" / "shgan_ffhqzip_val256_inpainting" / "0"
               / "shgan_ffhq256")
    with open(run_dir / "result.json") as f:
        res = json.load(f)
    assert np.isfinite([res["psnr"]["psnr"], res["ssim"]["ssim"]]).all()


def test_chip_smoke_fullmetrics_launch_rule(tmp_path, stand_in, lpips_params,
                                            monkeypatch):
    """The launch counts chip_smoke.py checks over the fullmetrics run,
    worked out from the modules, against the calls the stage makes (the
    stream and PPL's forwards), counted where each kernel's wrapper would
    launch it, K2's by route."""
    import importlib

    from shgan_torch.ops import noise_bias_act as nba
    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
    counts = {"stride1": 0, "up2": 0, "other": 0, "noise_bias_act": 0,
              "bias_lrelu": 0}
    fir_any, on = fir._fir_any, nba._on

    def counted_fir(x, taps, up, down, pads, counter):
        assert counter == "upfirdn2d"
        key = ("stride1" if tuple(up) == tuple(down) == (1, 1) else
               "up2" if tuple(up) == (2, 2) and tuple(down) == (1, 1)
               else "other")
        counts[key] += 1
        return fir_any(x, taps, up, down, pads, counter)

    def counted_on(x, cuda_fn, plain_fn):
        assert plain_fn is nba.noise_bias_act_plain
        fn = on(x, cuda_fn, plain_fn)

        def run(*a, **k):
            counts[nba.kernel_of(k.get("dcoefs"), k.get("noise_mode"))] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(fir, "_fir_any", counted_fir)
    monkeypatch.setattr(nba, "_on", counted_on)
    cfg = _fullmetrics_cfg(tmp_path, lpips_params, "a")
    ppl = next(e["args"] for e in cfg["eval"]["evaluator"]
               if e["type"] == "ppl")
    eval_stage()(cfg, device="cpu")
    rule = smoke.fullmetrics_launches(cfg["model_g"], BATCH, N_IMAGES,
                                      ppl["num_samples"], ppl["batch_size"])
    assert rule["stream_forwards"] == 2 and rule["ppl_batches"] == 2
    assert counts == dict(rule["upfirdn2d_by_route"],
                          noise_bias_act=rule["noise_bias_act"],
                          bias_lrelu=rule["bias_lrelu"])
