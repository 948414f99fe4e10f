"""The slice as a whole: the port's SH-GAN generator and InpaintEngine against
shgan_tpu at a tiny size on the CPU, weights carried by ``params_from_jax``,
``noise_mode='const'`` (the noise streams differ by design)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from shgan_tpu.checkpoint import (params_to_flat_state_dict,
                                  torch_state_dict_to_params)
from shgan_tpu.models import get_model as jax_get_model
from shgan_tpu.models.infer import z_for_positions as jax_z
from shgan_tpu.parallel import create_mesh
from shgan_tpu.runtime.config import model_cfg_bank as jax_bank
from shgan_tpu.serve import InpaintEngine as JaxEngine
from shgan_torch.checkpoint import load_pth, params_from_jax
from shgan_torch.models import get_model
from shgan_torch.models.infer import z_for_positions
from shgan_torch.runtime.config import model_cfg_bank
from shgan_torch.serve import InpaintEngine

RES = 32
ACT = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(res=RES):
    """tests/test_serve.py's tiny SH-GAN engine config, at ``res``."""
    enc = dict(resolution=res, ic_n=4, oc_n=32, ch_base=256, ch_max=8,
               use_fp16_before_res=None, resample_filter=[1, 3, 3, 1],
               activation=ACT, mbstd_group_size=0, mbstd_c_n=0, c_dim=None,
               cmap_dim=None, use_dropout=True, has_extra_final_layer=False,
               shu_input_res=16, shu_lowest_res=4, shu_channels=4,
               shu_df_freedom=[2, 3], shu_df_type="piecewise_linear",
               shu_tail_sigma_mult=3, shu_gaussian_at_input_res=False)
    num_ws = 2 * (int(np.log2(res)) - 1)
    return {"type": "comodgan_generator", "args": {
        "mapping": {"type": "comodgan_mapping",
                    "args": dict(z_dim=32, c_dim=0, w_dim=32, num_ws=num_ws,
                                 num_layers=2, activation=ACT,
                                 lr_multiplier=0.01)},
        "encoder": {"type": "shgan_encoder", "args": enc},
        "synthesis": {"type": "comodgan_synthesis",
                      "args": dict(w_dim=32, w0_dim=32, resolution=res,
                                   rgb_n=3, ch_base=256, ch_max=8,
                                   use_fp16_after_res=None,
                                   resample_filter=[1, 3, 3, 1],
                                   activation=ACT)}}}


def _nonzero_noise_and_bias(flat, seed=0):
    """Zero-initialised noise strengths and biases would hide the noise
    and bias paths: give them values."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith("noise_strength"):
            v = np.float32(0.3)
        elif k.endswith(".bias"):
            v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        out[k] = v
    return out


def test_parameter_names_match_jax():
    cfg = tiny_cfg()
    flat = params_to_flat_state_dict(
        jax_get_model(cfg).init(jax.random.key(0)))
    sd = get_model(cfg).state_dict()
    assert set(sd) == set(flat)
    for k, v in sd.items():
        assert tuple(v.shape) == flat[k].shape, k


def test_generator_matches_jax():
    cfg = tiny_cfg()
    jg = jax_get_model(cfg)
    flat = _nonzero_noise_and_bias(
        params_to_flat_state_dict(jg.init(jax.random.key(1))))
    jp = torch_state_dict_to_params(flat)
    tg = get_model(cfg)
    tg.load_state_dict(params_from_jax(flat), strict=True)
    rng = np.random.RandomState(6)
    n = 2
    real = rng.randn(n, 3, RES, RES).astype(np.float32)
    mask = (rng.rand(n, 1, RES, RES) > 0.4).astype(np.float32)
    x = np.concatenate([mask - 0.5, real * mask], axis=1)
    z = rng.randn(n, 32).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, x, z: jg(p, x, z, noise_mode="const"))(
            jp, jnp.asarray(x), jnp.asarray(z)))
    with torch.no_grad():
        got = tg(torch.from_numpy(x), torch.from_numpy(z),
                 noise_mode="const").numpy()
    assert got.shape == want.shape == (n, 3, RES, RES)
    err = np.abs(got - want).max()
    assert err <= 1e-3, f"max abs err {err}"


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, 3, RES, RES), dtype=np.uint8)
    masks = (rng.rand(n, RES, RES) > 0.4).astype(np.float32)
    return imgs, masks


def test_engine_matches_jax_engine_on_ragged_request():
    cfg = tiny_cfg()
    je = JaxEngine(cfg, batch_size=4, mesh=create_mesh(1), seed=7,
                   noise_mode="const")
    flat = _nonzero_noise_and_bias(params_to_flat_state_dict(je.params), 3)
    je.params = torch_state_dict_to_params(flat)
    te = InpaintEngine(cfg, batch_size=4, seed=7, noise_mode="const",
                       device="cpu")
    te.G.load_state_dict(params_from_jax(flat), strict=True)
    imgs, masks = _inputs(6, seed=1)  # one full chunk + a padded tail of 2
    want = je.inpaint(imgs, masks).astype(int)
    got = te.inpaint(imgs, masks).astype(int)
    assert got.shape == want.shape == (6, 3, RES, RES)
    assert np.abs(got - want).max() <= 1


def test_engine_composite_determinism_and_stream():
    e = InpaintEngine(tiny_cfg(), batch_size=4, seed=7, device="cpu",
                      latency_batches=(2,))
    with torch.no_grad():
        for name, p in e.G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.2)
    imgs, masks = _inputs(6, seed=2)
    a = e.inpaint(imgs, masks)
    b = e.inpaint(imgs, masks)
    assert a.shape == (6, 3, RES, RES) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    # known pixels pass through up to the uint8 round trip
    keep = masks[:, None].astype(bool) & np.ones_like(a, bool)
    assert np.abs(a.astype(int) - imgs.astype(int))[keep].max() <= 1
    # a different engine seed draws other noise (and other weights)
    e2 = InpaintEngine(tiny_cfg(), batch_size=4, seed=8, device="cpu")
    assert not np.array_equal(a, e2.inpaint(imgs, masks))

    def batches():
        for lo in range(0, 6, 4):
            yield imgs[lo:lo + 4], masks[lo:lo + 4]

    # the stream pads its tail to the full batch, inpaint to the bucket of
    # 2: equal on the full chunk
    streamed = list(e.inpaint_stream(batches()))
    assert [s.shape[0] for s in streamed] == [4, 2]
    np.testing.assert_array_equal(streamed[0], a[:4])
    assert e.inpaint(imgs[:0], masks[:0]).shape == (0, 3, RES, RES)


def test_engine_nhwc_and_float_inputs():
    e = InpaintEngine(tiny_cfg(), batch_size=2, seed=3, device="cpu",
                      noise_mode="none")
    imgs, masks = _inputs(2, seed=3)
    a = e.inpaint(imgs, masks)
    b = e.inpaint(imgs.transpose(0, 2, 3, 1), masks[:, None])
    np.testing.assert_array_equal(a, b)
    c = e.inpaint(imgs.astype(np.float32) / 127.5 - 1.0, masks)
    assert np.abs(a.astype(int) - c.astype(int)).max() <= 1


def test_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InpaintEngine(tiny_cfg(), batch_size=2)


def test_z_for_positions_bit_identical():
    pos = [0, 1, 5, 1000, 123456]
    np.testing.assert_array_equal(z_for_positions(3, 64, pos),
                                  jax_z(3, 64, pos))


@pytest.mark.parametrize("name", ["shgan_g256", "shgan_g512"])
def test_model_bank_matches_jax(name):
    assert model_cfg_bank()(name) == jax_bank()(name)


def test_pth_loads_strictly(tmp_path):
    cfg = tiny_cfg()
    g = get_model(cfg, seed=5)
    sd = {k: v.clone() for k, v in g.state_dict().items()}
    # released checkpoints carry resample_filter buffers: dropped on load
    f = torch.tensor(np.outer([1, 3, 3, 1], [1, 3, 3, 1]) / 64.0,
                     dtype=torch.float32)
    sd["encoder.b32.conv1.resample_filter"] = f
    path = str(tmp_path / "g.pth")
    torch.save(sd, path)
    e = InpaintEngine(cfg, pretrained=path, batch_size=2, seed=0,
                      device="cpu")
    for k, v in g.state_dict().items():
        assert torch.equal(e.G.state_dict()[k], v)
    bad = dict(sd)
    bad.pop("mapping.fc0.weight")
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="Missing"):
        InpaintEngine(cfg, pretrained=path, batch_size=2, device="cpu")
    assert "encoder.b32.conv1.resample_filter" not in load_pth(path)


def test_import_and_cpu_engine_leave_jax_out():
    """A fresh interpreter imports shgan_torch and runs the tiny engine on
    the CPU without importing jax or shgan_tpu."""
    code = (
        "import json, sys, numpy as np\n"
        "import shgan_torch\n"
        "import shgan_torch.main, shgan_torch.runtime.stages\n"
        "from shgan_torch.serve import InpaintEngine\n"
        f"cfg = json.loads({json.dumps(tiny_cfg())!r})\n"
        "e = InpaintEngine(cfg, batch_size=2, device='cpu')\n"
        "out = e.inpaint(np.zeros((3, 3, 32, 32), np.uint8),"
        " np.ones((3, 32, 32), np.float32))\n"
        "assert out.shape == (3, 3, 32, 32)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'shgan_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
