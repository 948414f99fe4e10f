"""The port's serving slice around the engine: a ``.pkl`` training snapshot
served through ``InpaintEngine``, ``generate_to_dir`` (the producer side of
``--evalnog_path``) against shgan_tpu's, the ``--evalnog_path`` consumer
reading its output back, and ``python -m shgan_torch.generate``.  Tiny SH-GAN
at 32² on the CPU, ``noise_mode="const"`` where the port is held to JAX
(composites within ±1: the two CPU backends round at a uint8 boundary
differently now and then).
"""

import glob
import importlib
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from shgan_tpu.checkpoint import (params_to_flat_state_dict,
                                  torch_state_dict_to_params)
from shgan_tpu.data import get_dataset as jax_get_dataset
from shgan_tpu.data.formatters import get_formatter as jax_get_formatter
from shgan_tpu.parallel import create_mesh
from shgan_tpu.serve import InpaintEngine as JaxEngine
from shgan_tpu.serve import generate_to_dir as jax_generate_to_dir
from shgan_torch import generate as cli
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.data.datasets import LoadGenDataset, get_dataset
from shgan_torch.data.formatters import get_formatter
from shgan_torch.eval import get_evaluator
from shgan_torch.models import get_model
from shgan_torch.runtime.stages import eval_stage
from shgan_torch.serve import InpaintEngine, generate_to_dir
from test_torch_models import REPO, _nonzero_noise_and_bias, tiny_cfg

RES = 32
DS = {"type": "synthetic", "args": {"resolution": RES, "length": 6,
                                    "seed": 1}}
FMT = {"type": "RandomMaskFormatter",
       "args": {"random_flip": False, "mask_resolution": RES,
                "impl": "numpy"}}


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, 3, RES, RES), dtype=np.uint8)
    masks = (rng.rand(n, RES, RES) > 0.4).astype(np.float32)
    return imgs, masks


def test_engine_serves_a_pkl_snapshot_as_its_pth(tmp_path):
    """A reference-format training snapshot (``chip_smoke.reference_pickle``,
    G_ema) and the same weights as a ``.pth``: the same bytes out; a
    non-strict ``.pth`` with a stray key loads too."""
    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    G = get_model(tiny_cfg(RES), seed=5)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.2)
    pkl = smoke.reference_pickle(G, str(tmp_path / "network-snapshot-1.pkl"))
    pth = str(tmp_path / "g.pth")
    torch.save(G.state_dict(), pth)
    imgs, masks = _inputs(3, seed=1)
    outs = [InpaintEngine(tiny_cfg(RES), pretrained=p, batch_size=4, seed=0,
                          noise_mode="const", device="cpu").inpaint(imgs,
                                                                    masks)
            for p in (pkl, pth)]
    np.testing.assert_array_equal(outs[0], outs[1])
    stray = str(tmp_path / "stray.pth")
    torch.save({**G.state_dict(), "not.a.weight": torch.zeros(2)}, stray)
    with pytest.raises(RuntimeError, match="not.a.weight"):
        InpaintEngine(tiny_cfg(RES), pretrained=stray, batch_size=4,
                      device="cpu")
    loose = InpaintEngine(tiny_cfg(RES), pretrained=stray, batch_size=4,
                          seed=0, noise_mode="const", strict=False,
                          device="cpu")
    np.testing.assert_array_equal(loose.inpaint(imgs, masks), outs[1])


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same weights, seed 3, noise const,
    batch 4 (six images: a full batch and a padded one)."""
    je = JaxEngine(tiny_cfg(RES), batch_size=4, mesh=create_mesh(1), seed=3,
                   noise_mode="const")
    flat = _nonzero_noise_and_bias(params_to_flat_state_dict(je.params), 2)
    je.params = torch_state_dict_to_params(flat)
    te = InpaintEngine(tiny_cfg(RES), batch_size=4, seed=3,
                       noise_mode="const", device="cpu")
    te.G.load_state_dict(params_from_jax(flat), strict=True)
    return je, te


def _pngs(d):
    return sorted(osp.basename(p) for p in glob.glob(osp.join(d, "*.png")))


def test_generate_to_dir_writes_each_row_once(engines, tmp_path):
    """``syn00000.png`` … for the six rows, none for the padding; each PNG
    is the engine's ``inpaint`` of that row with the pipeline's mask, byte
    for byte; a loadgen dataset reads the pairs back and the pregen eval
    scores them."""
    _, te = engines
    dataset, formatter = get_dataset(DS), get_formatter(FMT)
    out = str(tmp_path / "gen")
    logs = []
    n = generate_to_dir(te, dataset, formatter, out, num_threads=0,
                        log_every=1, log=logs.append)
    assert n == 6 and _pngs(out) == [f"syn{i:05d}.png" for i in range(6)]
    assert [m.split(",")[0] for m in logs] == ["generated 4/6",
                                               "generated 6/6"]
    from shgan_torch.data.pipeline import EvalPipeline
    rows = []
    for real, mask, valid, uids in EvalPipeline(dataset, formatter, 4,
                                                seed=te.seed, num_threads=0):
        got = te.inpaint(real, mask, start_index=len(rows))
        rows += [g for g, ok in zip(got, valid) if ok]
    for i, want in enumerate(rows):
        img = np.asarray(Image.open(osp.join(out, f"syn{i:05d}.png")))
        np.testing.assert_array_equal(img, want.transpose(1, 2, 0))
    lg = LoadGenDataset(dataset, out)
    el = lg[0]
    assert el["gen"].shape == el["image"].shape == (3, RES, RES)
    ev = get_evaluator([{"type": "psnr"}, {"type": "ssim"}])
    rv = eval_stage._eval_pregen(lg, ev, batch_size=4,
                                 log_dir=str(tmp_path),
                                 device=torch.device("cpu"),
                                 num_threads=0)
    assert np.isfinite(rv["psnr"]) and np.isfinite(rv["ssim"])


def test_generate_to_dir_matches_jax(engines, tmp_path):
    """The same weights, seed and dataset through both packages'
    ``generate_to_dir``: the same file names, composites within ±1."""
    je, te = engines
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_generate_to_dir(je, jax_get_dataset(DS), jax_get_formatter(FMT), a,
                        num_threads=0, log=lambda s: None)
    generate_to_dir(te, get_dataset(DS), get_formatter(FMT), b,
                    num_threads=0, log=lambda s: None)
    assert _pngs(a) == _pngs(b) and len(_pngs(a)) == 6
    for name in _pngs(a):
        x = np.asarray(Image.open(osp.join(a, name)), np.int16)
        y = np.asarray(Image.open(osp.join(b, name)), np.int16)
        assert np.abs(x - y).max() <= 1, name


def _run(args, cwd):
    env = dict(os.environ, SHGAN_LOG_ROOT=str(cwd / "log"),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run([sys.executable, "-m", "shgan_torch.generate",
                           *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=600)


def test_cli_debug_on_the_cpu(tmp_path):
    """``python -m shgan_torch.generate --debug --device cpu``: the
    experiment's full-width generator with random weights (the released
    ``.pth`` is absent), the synthetic fallback dataset, 2 images."""
    r = _run(["--experiment", "shgan_ffhq256_eval", "--out", "gen",
              "--debug", "--device", "cpu", "--n", "2", "--bf16"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "random init" in r.stdout and "wrote 2 images" in r.stdout
    assert len(_pngs(str(tmp_path / "gen"))) == 2


def test_cli_help_imports_no_jax():
    code = ("import sys, shgan_torch, shgan_torch.generate as g\n"
            "try:\n    g.main(['--help'])\nexcept SystemExit:\n    pass\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'shgan_tpu'))]\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--bf16" in r.stdout and "--device" in r.stdout


def test_cli_refuses_what_it_lacks(tmp_path, monkeypatch):
    """Outside ``--debug`` a missing ``.pth`` is a FileNotFoundError; with
    no ``--device cpu`` and no CUDA the engine raises."""
    with pytest.raises(FileNotFoundError):
        cli.main(["--experiment", "shgan_synthetic256_eval", "--out",
                  str(tmp_path / "g"), "--pretrained",
                  str(tmp_path / "none.pth")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--experiment", "shgan_synthetic256_eval", "--out",
                  str(tmp_path / "g"), "--debug", "--n", "1"])
