"""The port's ``.pth`` writer and ``python -m shgan_torch.export_pth``
against shgan_tpu: the same params written by both packages give the same
files' contents, and a port training snapshot exported to ``.pth`` loads
strictly into the JAX generator with the same forward (the port → JAX
round trip)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from shgan_tpu.checkpoint import (load_torch_pth, save_torch_pth as j_save,
                                  torch_state_dict_to_params)
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.runtime.stages import _merge_params
from shgan_torch.checkpoint import save_torch_pth as t_save
from shgan_torch.checkpoint.train_state import save_train_state
from shgan_torch.export_pth import load_snapshot_network
from shgan_torch.export_pth import main as export_main
from shgan_torch.models import get_model
from shgan_torch.train import TrainConfig, TrainStep

from test_torch_models import REPO, tiny_cfg
from test_torch_snapshot import dnnlib  # noqa: F401  (fixture)
from test_torch_train_ops import tiny_d_cfg


def _read(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _same_files(a, b):
    sa, sb = _read(a), _read(b)
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].shape == sb[k].shape and sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


def _numpy(tree):
    """numpy leaves in the tree's own key order (``jax.tree.map`` sorts)."""
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("nested", [True, False])
def test_writer_matches_jax(tmp_path, nested):
    """The JAX params of a tiny generator (nested, or flattened): both
    writers give the same keys in the same order, shapes (0-d leaves stay
    0-d), float32 and the same values, bit for bit."""
    params = jax_get_model(tiny_cfg(32)).init(jax.random.key(0))
    if not nested:
        from shgan_tpu.checkpoint import params_to_flat_state_dict
        params = params_to_flat_state_dict(params)
    j_save(str(tmp_path / "j.pth"), params)
    t_save(str(tmp_path / "t.pth"), _numpy(params))
    _same_files(tmp_path / "j.pth", tmp_path / "t.pth")
    sd = _read(tmp_path / "t.pth")
    assert sd["synthesis.b4.conv.noise_strength"].shape == ()
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_writer_takes_a_port_state_dict(tmp_path):
    """A port state_dict of tensors (float64 ones among them) is written
    in its own key order as float32 tensors."""
    G = get_model(tiny_cfg(32), seed=2)
    sd = {k: v.double() if i % 2 else v
          for i, (k, v) in enumerate(G.state_dict().items())}
    t_save(str(tmp_path / "g.pth"), sd)
    got = _read(tmp_path / "g.pth")
    assert list(got) == list(sd)
    for k, v in G.state_dict().items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        assert torch.equal(got[k], v), k


@pytest.fixture()
def snapshot(tmp_path):
    """A port training snapshot of tiny G / D, its G_ema moved off G."""
    cfg = tiny_cfg(32)
    step = TrainStep(get_model(cfg, seed=1), get_model(tiny_d_cfg(32)),
                     TrainConfig())
    with torch.no_grad():
        for p in step.G_ema.parameters():
            p.add_(0.01)
        for name, p in step.G_ema.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    path = str(tmp_path / "weight" / "network-snapshot-000000")
    save_train_state(path, step)
    return cfg, step, path


def test_port_snapshot_to_jax_generator(tmp_path, snapshot):
    """``python -m shgan_torch.export_pth`` of a port snapshot → a ``.pth``
    that the JAX package loads strictly (``load_torch_pth`` →
    ``torch_state_dict_to_params`` → ``_merge_params(strict=True)``); its
    forward with constant noise equals the port's G_ema within 1e-3."""
    cfg, step, path = snapshot
    out = str(tmp_path / "best.pth")
    r = subprocess.run(
        [sys.executable, "-m", "shgan_torch.export_pth", "--snapshot", path,
         "--out", out], capture_output=True, text=True, timeout=300,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "from G_ema" in r.stdout
    jG = jax_get_model(cfg)
    params = _merge_params(jG.init(jax.random.key(9)),
                           torch_state_dict_to_params(load_torch_pth(out)),
                           strict=True)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 32, 32).astype(np.float32)
    z = rng.randn(2, 32).astype(np.float32)
    want = np.asarray(jG(params, x, z, noise_mode="const"))
    with torch.no_grad():
        got = step.G_ema(torch.from_numpy(x), torch.from_numpy(z),
                         noise_mode="const").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_export_keys_and_sources(tmp_path, snapshot, dnnlib):  # noqa: F811
    """``--key`` takes G_ema / G / D and JAX's names; the snapshot may be
    the directory, its ``state.pt`` or a reference ``.pkl``; a legacy TF
    pickle and an unknown key are refused."""
    import importlib
    import pickle
    cfg, step, path = snapshot
    for key, net in (("G", step.G), ("params_d", step.D),
                     ("params_gema", step.G_ema)):
        out = str(tmp_path / f"{key}.pth")
        export_main(["--snapshot", os.path.join(path, "state.pt"), "--out",
                     out, "--key", key])
        got = _read(out)
        assert list(got) == list(net.state_dict())
        for k, v in net.state_dict().items():
            assert torch.equal(got[k], v), (key, k)
    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    pkl = smoke.reference_pickle(step.G_ema, str(tmp_path / "s.pkl"))
    export_main(["--snapshot", pkl, "--out", str(tmp_path / "p.pth")])
    _same_files(tmp_path / "p.pth", tmp_path / "params_gema.pth")
    with pytest.raises(SystemExit, match="available"):
        load_snapshot_network(path, "opt_g")
    g = dnnlib()
    g.version, g.components, g.variables = 4, {}, []
    with open(tmp_path / "tf.pkl", "wb") as f:
        pickle.dump((g, g, g), f)
    with pytest.raises(SystemExit, match="TF"):
        load_snapshot_network(str(tmp_path / "tf.pkl"))
