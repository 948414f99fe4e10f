"""Spatial (H) sharding in the port (``shgan_torch/parallel/spatial.py``) on
the CPU: gloo ranks, each a process of ``tests/torch_mh_driver.py`` with a
model axis, against the unsharded port computed in the same process; the
noise window and K3's slab mode in their plain versions; and one cross test
against JAX's sharded generator on a four-device virtual CPU mesh.

Bounds.  The ops on slabs run each output element's arithmetic as the
unsharded op does (the halo puts the same rows where the padding was), so
the forward is equal; their gradients sum a rank's share first and then
the ranks' shares, another order than one sum over the plane: each
derivative is held to 1e-6 of its largest magnitude.  The generator is held
to 2e-4 and the train step to the bounds of ``__graft_entry__.py:184-241``
(losses 1e-4, parameters 5e-5), the JAX package's own for its sharded run.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from shgan_torch.ops import noise as noise_ops
from shgan_torch.ops.conv1024 import conv3x3_lowch, conv3x3_lowch_plain
from shgan_torch.ops.conv_resample import conv2d_resample
from shgan_torch.ops.noise_bias_act import (noise_bias_act_grad_plain,
                                            noise_bias_act_mask_plain,
                                            noise_bias_act_plain)
from shgan_torch.parallel import Mesh, spatial
from shgan_torch.parallel.mesh import MODEL_GRAD_RTOL
from shgan_torch.parallel.spatial import (HALO, Slab, constrain, level,
                                          spatial_sharding)
from mh_launch import Ranks, rank_env

# step 0's gradient leaves, each relative to its norm, against the 1-rank
# step (measured ≤ 5e-5: another summation order); a partial gradient that
# missed the gradient rule is off by about half its norm
GRAD_LEAF_TOL = 1e-3

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(HERE)
RANK_SCRIPT = osp.join(HERE, "torch_mh_driver.py")

# (world, model, modes): the driver runs a case's modes in one group
RUNS = {
    "m2": (2, 2, "spatial_ops,spatial_g,spatial_step"),
    "m4": (4, 4, "spatial_ops,spatial_g,spatial_step"),
    "d2m2": (4, 2, "spatial_g"),
    "m1": (2, 1, "spatial_step"),
}


def _env():
    return rank_env(1)


def _start(out_dir, world, model, modes):
    """The ranks of one case, on a port reserved until they end
    (``mh_launch``)."""
    return Ranks(RANK_SCRIPT, world, [out_dir, modes, model], out_dir,
                 _env(), timeout=300)


def _finish(run):
    """Wait for ``run``'s ranks: every one exits 0, or the case fails at its
    first failed rank, or at its deadline, with every rank's output."""
    run.wait()


def _json(out_dir, name, rank):
    with open(osp.join(out_dir, f"{name}_rank{rank}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank case and the JAX subprocess, started together
    (they share the CPU); the port's ranks on JAX's weights once JAX has
    written them."""
    root = tmp_path_factory.mktemp("spatial")
    jax_dir = str(root / "jax")
    os.makedirs(jax_dir)
    env = dict(_env(), JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_G, osp.join(jax_dir, "jax_g.npz"), REPO],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    started = {name: (str(root / name), _start(str(root / name), *spec))
               for name, spec in RUNS.items()}
    try:
        out = jax_proc.communicate(timeout=300)[0]
        assert jax_proc.returncode == 0, out[-3000:]
        _finish(_start(jax_dir, 2, 2, "spatial_jax"))
        for _, run in started.values():
            _finish(run)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
        for _, run in started.values():
            run.stop()
    return {"jax": jax_dir, **{name: out_dir
                               for name, (out_dir, _) in started.items()}}


# ---------------------------------------------------------------------------
# the API (the port's counterparts of tests/test_spatial_sharding.py:18-37)
# ---------------------------------------------------------------------------


def test_constrain_noop_when_inactive():
    x = torch.ones((2, 3, 64, 64))
    assert constrain(x) is x
    assert constrain(None) is None
    mesh = Mesh(world=4, rank=1)   # model axis 1
    with spatial_sharding(mesh, min_res=32):
        assert spatial.active() is None
        assert constrain(x) is x   # model = 1: inactive


def test_constrain_skips_small_and_indivisible():
    mesh = Mesh(world=4, rank=1, model=4)
    with spatial_sharding(mesh, min_res=64):
        small = torch.ones((2, 3, 32, 32))
        assert constrain(small) is small          # below threshold
        odd = torch.ones((2, 3, 66, 66))
        assert constrain(odd) is odd              # 66 % 4 != 0
        ok = torch.arange(8 * 3 * 64 * 64.0).reshape(8, 3, 64, 64)
        out = constrain(ok)                       # rank 1's rows
        assert out.shape == (8, 3, 16, 64)
        assert torch.equal(out, ok[:, :, 16:32])
    eight = Mesh(world=8, rank=1, model=8)
    with spatial_sharding(eight, min_res=4):
        # fewer rows a rank than a level's halo (8 / 8 < HALO), or an odd
        # number of them (24 / 8: not a multiple of down = 2) stay whole
        for h in (8, 24):
            x = torch.ones((1, 1, h, h))
            assert constrain(x) is x and level(h) is None, h
        assert 8 // 8 < HALO
        assert level(16) == Slab(2, 4, 16, eight)
    with spatial_sharding(Mesh(world=2, rank=0, model=2), min_res=4):
        assert level(4) is None                   # the dense 4² level
    assert constrain(ok) is ok                    # the context is over


def test_mesh_is_data_major():
    """rank = data_index * model + model_index, as in the JAX mesh; the
    batch splits over the data axis alone."""
    meshes = [Mesh(world=4, rank=r, model=2) for r in range(4)]
    assert [(m.data_index, m.model_index) for m in meshes] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [m.split(8) for m in meshes] == [(0, 4), (0, 4), (4, 8), (4, 8)]
    assert [m.model_rank(1) for m in meshes] == [1, 1, 3, 3]
    assert Mesh(world=2, rank=0, model=2).rows(8) is None
    assert Mesh(world=4, rank=3, model=2).rows(8).start == 4
    with pytest.raises(ValueError, match="does not divide"):
        Mesh(world=4, rank=0, model=3)


# ---------------------------------------------------------------------------
# the kernels' new modes, in their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res", [16, 64])
def test_noise_window_draws_the_planes_rows_bit_for_bit(res):
    key = noise_ops.noise_key(5, 2 * res)
    whole = noise_ops.philox_normal_plain(key, 3, res, row0=2)
    for m in (2, 4, 8):
        r = res // m
        for i in range(m):
            got = noise_ops.philox_normal_plain(key, 3, res, row0=2,
                                                h0=i * r, rows=r)
            want = whole[:, i * r:(i + 1) * r]
            assert torch.equal(got.view(torch.int32),
                               want.contiguous().view(torch.int32)), (m, i)
    # a window across the cos / sin halves
    got = noise_ops.philox_normal_plain(key, 3, res, row0=2, h0=res // 2 - 3,
                                        rows=6)
    assert torch.equal(got, whole[:, res // 2 - 3:res // 2 + 3])


@pytest.mark.parametrize("mode", ["random", "const"])
def test_epilogue_window_is_the_planes_rows(mode):
    """The fused epilogue's plain version and its grad kernel's (both
    modes) on rows [h0, h0 + rows): the whole plane's rows bit for bit; the
    window's sums add up to the plane's."""
    g = torch.Generator().manual_seed(3)
    n, c, res = 2, 3, 32
    x = torch.randn((n, c, res, res), generator=g) * 2
    dy = torch.randn((n, c, res, res), generator=g)
    v = torch.randn((n, c, res, res), generator=g)
    const = torch.randn((res, res), generator=g)
    kw = dict(dcoefs=torch.rand((n, c), generator=g) + 0.5,
              bias=torch.randn((c,), generator=g) * 0.1,
              act=(0.2, 2 ** 0.5, 256.0), noise_mode=mode,
              noise_key=noise_ops.noise_key(1, 64), strength=torch.tensor(0.3),
              row0=1)
    whole = dict(kw, noise_const=const)
    y = noise_bias_act_plain(x, **whole)
    dx, dd, db, ds = noise_bias_act_grad_plain(dy, x, **whole)
    mk = noise_bias_act_mask_plain(v, x, vs=torch.tensor(0.7), **whole)
    sums = [torch.zeros_like(dd), torch.zeros_like(db), torch.zeros(())]
    for h0, h1 in ((0, 8), (8, 16), (16, 24), (24, 32)):
        part = dict(kw, noise_const=const[h0:h1], h0=h0)
        rows = slice(h0, h1)
        assert torch.equal(noise_bias_act_plain(x[:, :, rows], **part),
                           y[:, :, rows])
        gx, *s = noise_bias_act_grad_plain(dy[:, :, rows], x[:, :, rows],
                                           **part)
        assert torch.equal(gx, dx[:, :, rows])
        sums = [a + b for a, b in zip(sums, s)]
        assert torch.equal(noise_bias_act_mask_plain(
            v[:, :, rows], x[:, :, rows], vs=torch.tensor(0.7), **part),
            mk[:, :, rows])
    for got, want in zip(sums, (dd, db, ds)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k3_slab_mode_is_the_planes_rows():
    """K3's plain version on a slab with a row of halo above and below:
    the whole plane's rows bit for bit; and ``conv2d_resample`` on a slab of
    a 1024² plane routes the conv to it, eligibility decided on the whole
    plane (the slab alone, 256 x 1024, is not eligible)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, 4, 64, 40), generator=g)
    w = torch.randn((6, 4, 3, 3), generator=g) * 0.2
    whole = conv3x3_lowch(x, w)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
    for r in (8, 16, 32):
        for h0 in range(0, 64, r):
            got = conv3x3_lowch(xp[:, :, h0:h0 + r + 2], w, halo=1)
            assert torch.equal(got, whole[:, :, h0:h0 + r])
    with pytest.raises(ValueError, match="rows"):
        conv3x3_lowch(xp[:, :, :14], w, halo=1)       # 12 rows: 8 ∤ 12

    big = torch.randn((1, 2, 1024, 1024), generator=g)
    w2 = torch.randn((3, 2, 3, 3), generator=g) * 0.2
    want = conv3x3_lowch_plain(big, w2)
    mesh = Mesh(world=4, rank=0, model=4)
    for h0 in (0, 512):
        slab = Slab(h0, h0 + 256, 1024, mesh)
        got = conv2d_resample(big, w2, padding=1, slab=slab, src=None)
        assert torch.equal(got, want[:, :, h0:h0 + 256])


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,world", [("m2", 2), ("m4", 4)])
def test_ops_on_slabs_match_the_unsharded_ops(runs, case, world):
    """3×3 pad 1, 1×1, the encoder's down = 2 conv, the synthesis up = 2
    conv, the skip image's upsample2d, a synthesis layer (random noise, up
    = 2; const noise) and ToRGB, from slabs and from a whole input: the
    gathered output, the gradients of the input and every replicated leaf,
    and the second order, against the unsharded op."""
    for r in range(world):
        rec = _json(runs[case], "spatial_ops", r)
        assert rec["transport"] == "gloo"
        assert rec["traffic"]["halo_bytes"] > 0
        assert len(rec["errs"]) == 12
        for name, orders in rec["errs"].items():
            assert orders["forward"][0] == 0.0, (name, orders)
            for order in ("backward", "second"):
                err, scale = orders[order]
                assert err <= 1e-6 * scale, (r, name, order, err, scale)


@pytest.mark.parametrize("case,world", [("m2", 2), ("d2m2", 4), ("m4", 4)])
def test_sharded_generator_matches_unsharded(runs, case, world):
    for r in range(world):
        rec = _json(runs[case], "spatial_g", r)
        assert rec["traffic"]["halo_bytes"] > 0, rec
        assert rec["const_err"] <= 2e-4 and rec["random_err"] <= 2e-4, rec


def _sharded_step_holds(out_dir, world):
    recs = [_json(out_dir, "spatial_step", r) for r in range(world)]
    for rec in recs:
        assert max(rec["loss_err"].values()) <= 1e-4, rec
        assert rec["param_err"] <= 5e-5, rec
        assert rec["grad_leaf_rel"] <= GRAD_LEAF_TOL, rec
        assert np.isfinite(list(rec["metrics"].values())).all()
    # check_replicated on the ranks passed (bit for bit) inside the driver
    assert all(rec["metrics"] == recs[0]["metrics"] for rec in recs)


def test_train_step_at_model_2_matches_one_rank(runs):
    """One TrainStep with both regularizers: Gpl's inner gradient goes
    through the slabs, so it is whole only by the gradient rule."""
    _sharded_step_holds(runs["m2"], 2)


def test_train_step_at_model_4_matches_one_rank(runs):
    """The same step on four model ranks (16² levels of 4 rows a rank)."""
    _sharded_step_holds(runs["m4"], 4)


def test_average_grads_refuses_model_ranks_apart(runs):
    """A model group's copies of a gradient must agree (the gradient rule);
    the step's own stayed within MODEL_GRAD_RTOL of each other."""
    for r in (0, 1):
        rec = _json(runs["m2"], "spatial_step", r)
        assert rec["apart_refused"], rec
        assert rec["replica_gap"] <= MODEL_GRAD_RTOL, rec


def test_model_1_mesh_step_is_todays_bit_for_bit(runs):
    for r in (0, 1):
        rec = _json(runs["m1"], "spatial_step", r)
        assert rec["model1_bit_equal"] and rec["model1_metrics_equal"], rec


JAX_G = r"""
import sys
import numpy as np
import jax
sys.path.insert(0, sys.argv[2])
from shgan_tpu.checkpoint import params_to_flat_state_dict
from shgan_tpu.models import get_model
from shgan_tpu.parallel import create_mesh, replicated, shard_batch
from shgan_tpu.parallel.spatial import spatial_sharding

assert len(jax.devices()) == 4, jax.devices()
ACT = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
res = 64
enc = dict(resolution=res, ic_n=4, oc_n=32, ch_base=256, ch_max=8,
           use_fp16_before_res=None, activation=ACT, mbstd_group_size=0,
           mbstd_c_n=0, c_dim=None, cmap_dim=None, use_dropout=True,
           has_extra_final_layer=False, shu_input_res=16, shu_lowest_res=4,
           shu_channels=4, shu_df_freedom=[2, 3],
           shu_df_type="piecewise_linear", shu_tail_sigma_mult=3,
           shu_gaussian_at_input_res=False)
G = get_model({"type": "comodgan_generator", "args": {
    "mapping": {"type": "comodgan_mapping",
                "args": dict(z_dim=32, c_dim=0, w_dim=32, num_ws=10,
                             num_layers=2, activation=ACT,
                             lr_multiplier=0.01)},
    "encoder": {"type": "shgan_encoder", "args": enc},
    "synthesis": {"type": "comodgan_synthesis",
                  "args": dict(w_dim=32, w0_dim=32, resolution=res, rgb_n=3,
                               ch_base=256, ch_max=8,
                               use_fp16_after_res=None, activation=ACT)}}})
rng = np.random.RandomState(0)
n = 4
real = rng.randn(n, 3, res, res).astype(np.float32)
mask = (rng.rand(n, 1, res, res) > 0.5).astype(np.float32)
z = rng.randn(n, 32).astype(np.float32)
x = np.concatenate([mask - 0.5, real * mask], axis=1)
gp = G.init(jax.random.key(5))
fwd = jax.jit(lambda p, x, z: G(p, x, z, noise_mode="const"))
mesh = create_mesh(4, model=2)
px, pz = shard_batch((x, z), mesh)
with spatial_sharding(mesh, min_res=16):
    got = np.asarray(fwd(jax.device_put(gp, replicated(mesh)), px, pz))
out = {"x": x, "z": z, "img": got}
for k, v in params_to_flat_state_dict(gp).items():
    out["p:" + k] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def test_sharded_generator_matches_jax_sharded(runs):
    """JAX's generator under ``spatial_sharding(create_mesh(4, model=2),
    16)`` on a four-device virtual CPU mesh against the port's on two
    model ranks, with JAX's weights, const noise: within 2e-4."""
    with np.load(osp.join(runs["jax"], "jax_g.npz")) as j:
        want = j["img"]
    for rank in (0, 1):
        with np.load(osp.join(runs["jax"],
                              f"spatial_jax_rank{rank}.npz")) as t:
            got = t["const"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
