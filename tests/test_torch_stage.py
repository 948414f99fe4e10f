"""The eval stage as a whole, and its command line: the port's ``eval_stage``
against shgan_tpu's on one tiny config on the CPU (same weights from one
``.pth``, same data, masks and latents, ``noise_mode='const'``), the
``python -m shgan_torch.main`` CLI in a subprocess, and a fresh interpreter
that runs the stage without importing JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shgan_tpu.checkpoint import params_to_flat_state_dict
from shgan_tpu.eval import base as jbase
from shgan_tpu.eval.fid import FIDEvaluator as JaxFID
from shgan_tpu.eval.inception import \
    load_inception_params as jax_inception_params
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.runtime.stages import eval_stage as jax_eval_stage
from shgan_torch.eval import base as tbase
from shgan_torch.eval.fid import FIDEvaluator, feature_stats, frechet_distance
from shgan_torch.eval.inception import (load_inception_params,
                                        random_inception_state_dict)
from shgan_torch.main import build_config
from shgan_torch.runtime.stages import eval_stage

from test_torch_models import REPO, RES, _nonzero_noise_and_bias, tiny_cfg

N_IMAGES, BATCH = 4, 2


def _capture_classes(base_mod, fid_cls):
    """A pixel-capturing and a feature-capturing evaluator for one
    package's registry; what they see lands in ``store``."""
    store = {"fake": [], "feat": None}

    class Capture(base_mod.BaseEvaluator):
        def add_batch(self, fake=None, valid=None, **_):
            (fake,) = self._apply_valid([fake], valid)
            store["fake"].append(np.asarray(fake))

        def compute(self):
            self.final = {"n": sum(len(f) for f in store["fake"])}
            return self.final["n"]

    class FIDCapture(fid_cls):
        def compute(self):
            store["feat"] = self._gather()[:2]
            return super().compute()

    return store, Capture, FIDCapture


def _register(base_mod, fid_cls, monkeypatch):
    store, cap, fid_cap = _capture_classes(base_mod, fid_cls)
    reg = dict(base_mod._EVALUATOR_REGISTRY)
    monkeypatch.setattr(base_mod, "_EVALUATOR_REGISTRY", reg)
    base_mod.register_evaluator("capture_fake")(cap)
    base_mod.register_evaluator("fid")(fid_cap)
    return store


def _stage_cfg(tmp_path, pth, det_params, name):
    return {
        "env": {"rnd_seed": 7, "mesh_devices": 1},
        "model_g": tiny_cfg(),
        "eval": {
            "dataset": {
                "type": "synthetic", "name": "syn32",
                "args": {"resolution": RES, "length": N_IMAGES, "seed": 3},
                "formatter": {"type": "RandomMaskFormatter",
                              "args": {"random_flip": False,
                                       "mask_resolution": RES,
                                       "hole_range": [0, 1],
                                       "impl": "numpy"}}},
            "evaluator": [
                {"type": "psnr", "args": {"for_dataset": None,
                                          "rgb_range": 1}},
                {"type": "ssim", "args": {"window_size": 11}},
                {"type": "fid", "args": {"detector_params": det_params}},
                {"type": "capture_fake"}],
            "batch_size": BATCH,
            "dataset_num_workers": 0,
            "log_dir": str(tmp_path / name),
            "log_display": 100,
            "pallas_noise": False,
            "noise_mode": "const",
            "pretrained_pth": pth,
            "strict_sd": True,
        },
    }


def test_eval_stage_matches_jax(tmp_path, monkeypatch):
    import jax

    flat = _nonzero_noise_and_bias(params_to_flat_state_dict(
        jax_get_model(tiny_cfg()).init(jax.random.key(2))), 4)
    pth = str(tmp_path / "g.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
               pth)
    inc_sd = random_inception_state_dict(5)
    jstore = _register(jbase, JaxFID, monkeypatch)
    tstore = _register(tbase, FIDEvaluator, monkeypatch)

    jrv = jax_eval_stage()(_stage_cfg(tmp_path, pth,
                                      jax_inception_params(inc_sd), "jax"))
    trv = eval_stage()(_stage_cfg(tmp_path, pth,
                                  load_inception_params(inc_sd), "torch"),
                       device="cpu")

    # the uint8 composites: within ±1 at every pixel
    jf, tf = np.concatenate(jstore["fake"]), np.concatenate(tstore["fake"])
    assert jf.shape == tf.shape == (N_IMAGES, 3, RES, RES)
    assert np.abs(jf - tf).max() <= 1
    j, t = jrv["eval_rv"], trv["eval_rv"]
    assert t["psnr"] == pytest.approx(j["psnr"], abs=1e-3)
    assert t["ssim"] == pytest.approx(j["ssim"], abs=1e-3)
    # FID: the port's formulas on the JAX features give the JAX FID; the
    # real images are the same bytes, so their features agree
    (jfake, jreal), (tfake, treal) = jstore["feat"], tstore["feat"]
    fid_of_jax = frechet_distance(*feature_stats(jfake, N_IMAGES),
                                  *feature_stats(jreal, N_IMAGES))
    assert fid_of_jax == pytest.approx(j["fid"], rel=1e-9)
    assert np.isfinite(t["fid"])
    assert np.abs(treal - jreal).max() <= 1e-3
    assert t["capture_fake"] == j["capture_fake"] == N_IMAGES
    # timing: one wall time per batch, and result.json written
    assert len(trv["timing"]["batch_s"]) == N_IMAGES // BATCH
    assert trv["timing"]["global_batch"] == BATCH
    with open(tmp_path / "torch" / "result.json") as f:
        saved = json.load(f)
    assert saved["fid"]["fid"] == pytest.approx(t["fid"])
    assert saved["psnr"]["psnr"] == pytest.approx(t["psnr"])


def test_eval_stage_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """What the stage once refused now runs: ``env.mesh_devices: 2`` in one
    process runs the global batch of two devices on one and equals
    ``mesh_devices: 1`` at the doubled batch; ``device_image_bank`` (a TPU
    formulation) runs the host pipeline.  A run without CUDA that asks for
    the card still raises."""
    def cfg_of(name, mesh_devices, per_gpu, bank=False):
        cfg = _stage_cfg(tmp_path, None, None, name)
        ev = cfg["eval"]
        ev.pop("batch_size")
        ev.update(evaluator=[{"type": "psnr"}, {"type": "ssim"}],
                  pretrained_pth=None, batch_size_per_gpu=per_gpu,
                  device_image_bank=bank, noise_mode="random")
        cfg["env"]["mesh_devices"] = mesh_devices
        return cfg

    two = eval_stage()(cfg_of("two", 2, BATCH), device="cpu")
    one = eval_stage()(cfg_of("one", 1, 2 * BATCH), device="cpu")
    bank = eval_stage()(cfg_of("bank", 2, BATCH, bank=True), device="cpu")
    assert two["eval_rv"] == one["eval_rv"] == bank["eval_rv"]
    assert two["timing"]["global_batch"] == one["timing"]["global_batch"] \
        == 2 * BATCH
    for name in ("two", "one", "bank"):
        assert (tmp_path / name / "result.json").is_file()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_stage()(cfg_of("x", 1, BATCH))


def test_eval_stage_random_noise_does_not_depend_on_the_batch(tmp_path):
    """z and the random noise of dataset position i are the same at any
    batch size: the composites of a batch-1 and a batch-4 run differ only
    through the style normalization's batch mean, which demodulation
    cancels up to its 1e-8 epsilon and rounding."""
    from shgan_torch.models import get_model
    G = get_model(tiny_cfg(), seed=7)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    pth = str(tmp_path / "g.pth")
    torch.save(G.state_dict(), pth)
    outs = {}
    for bs in (1, 4):
        cfg = _stage_cfg(tmp_path, pth, None, f"b{bs}")
        cfg["eval"].update(evaluator=[{"type": "psnr"}], batch_size=bs,
                           noise_mode="random")
        outs[bs] = eval_stage()(cfg, device="cpu")["eval_rv"]["psnr"]
    cfg["eval"]["noise_mode"] = "none"
    quiet = eval_stage()(cfg, device="cpu")["eval_rv"]["psnr"]
    assert outs[1] == pytest.approx(outs[4], abs=1e-4)
    assert abs(quiet - outs[4]) > 1e-3   # the noise reaches the image


def _cli(args, tmp_path):
    env = dict(os.environ, SHGAN_LOG_ROOT=str(tmp_path))
    return subprocess.run(
        [sys.executable, "-m", "shgan_torch.main", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


def test_cli_debug_eval_writes_result(tmp_path):
    r = _cli(["--experiment", "shgan_synthetic256_eval", "--debug", "--eval",
              "0", "--device", "cpu", "--pick", "syn00000", "syn00001",
              "syn00002"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    run_dir = tmp_path / "shgan_synthetic256_inpainting" / "0" \
        / "shgan_synthetic256"
    with open(run_dir / "result.json") as f:
        res = json.load(f)
    assert np.isfinite(res["psnr"]["psnr"]) and np.isfinite(
        res["ssim"]["ssim"])
    assert (run_dir / "config.yaml").is_file()
    assert "Evaluator psnr" in (run_dir / "eval.log").read_text()


def test_cli_refuses_training(tmp_path):
    """Training an experiment without a train section, or a nested eval
    the train stage does not run (``is``), is refused; a training config
    keeps its eval section for the nested eval."""
    cfg = build_config("shgan_ffhq256_train", log_root=str(tmp_path))
    assert cfg["eval"]["dataset"]["name"] == "ffhqzip_val256_inpainting"
    assert cfg["train"]["log_dir"].endswith("train")
    r = _cli(["--experiment", "shgan_synthetic256_eval", "--resume_path",
              "x"], tmp_path)
    assert r.returncode != 0 and "no train section" in r.stderr
    cfg = build_config("smoke_train", log_root=str(tmp_path),
                       overrides={"train.eval_every_kimg": 1})
    cfg["eval"] = {"dataset": cfg["train"]["dataset"],
                   "nested_eval_metric": "is"}
    from shgan_torch.runtime.stages import train_stage
    with pytest.raises(ValueError, match="unsupported"):
        train_stage()(cfg, device="cpu")


def test_build_config_applies_overrides(tmp_path):
    cfg = build_config("shgan_synthetic256_eval", debug=True, eval_id=3,
                       seed=11, model="shgan_g1024", eval_tag="t",
                       pretrained="w.pth", log_root=str(tmp_path))
    assert cfg["model_g"]["args"]["synthesis"]["args"]["resolution"] == 1024
    assert cfg["env"]["rnd_seed"] == 11 and cfg["env"]["debug"] is True
    assert cfg["eval"]["batch_size_per_gpu"] == 2
    assert cfg["eval"]["pretrained_pth"] == "w.pth"
    assert cfg["eval"]["log_dir"] == os.path.join(
        str(tmp_path), "shgan_synthetic256_inpainting", "3", "t")
    assert "train" not in cfg


def test_stage_and_cli_leave_jax_out(tmp_path):
    """A fresh interpreter imports the CLI and the stage and runs a tiny
    eval on the CPU without importing jax or shgan_tpu; so do the readers,
    the LaMa masks, the formatters, KID / PR / IS, LPIPS and PPL."""
    cfg = _stage_cfg(tmp_path, None, None, "iso")
    cfg["eval"]["evaluator"] = [{"type": "psnr"}, {"type": "ssim"}]
    cfg["eval"]["pretrained_pth"] = None
    code = (
        "import json, sys\n"
        "import shgan_torch.main\n"
        "from shgan_torch.runtime.stages import eval_stage\n"
        f"cfg = json.loads({json.dumps(cfg)!r})\n"
        "rv = eval_stage()(cfg, device='cpu')\n"
        "assert set(rv['eval_rv']) == {'psnr', 'ssim'}, rv\n"
        "import numpy as np\n"
        "from shgan_torch.data import datasets, formatters, masks\n"
        "from shgan_torch.eval import (feature_metrics, lpips, ppl,\n"
        "                              stylegan_metrics)\n"
        "from shgan_torch.eval.base import get_evaluator\n"
        "assert masks.lama_generator('medium', 256)(\n"
        "    np.zeros((3, 256, 256), np.float32)).sum() > 0\n"
        "for name in sorted(formatters._FORMATTER_REGISTRY):\n"
        "    if name != 'FixedMaskFormatter':\n"
        "        formatters.get_formatter(name)\n"
        "ev = get_evaluator([\n"
        "    {'type': 'lpips', 'args': {'params': lpips.random_lpips_params()}},\n"
        "    {'type': 'ppl', 'args': {\n"
        "        'lpips_params': lpips.random_vgg16_lpips_params()}}])\n"
        "assert ev.needs_generator and 'ffhqzip' in datasets._DATASET_REGISTRY\n"
        "assert np.isfinite(stylegan_metrics.compute_kid(\n"
        "    np.eye(4), np.eye(4)[::-1], 3, 4))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'shgan_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
