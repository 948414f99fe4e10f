"""The port's data parallelism (``shgan_torch.parallel``) on the CPU: two
gloo ranks, each a process of ``tests/torch_mh_driver.py``, against one
process at ``smoke_train``'s 32² plan; the engine over two CPU devices
against one; and the minibatch stddev's question settled on the JAX side,
with JAX's discriminator on a two-device virtual CPU mesh in a subprocess.

Tolerances: a W-rank run computes what one process computes on the whole
batch, with the same draws, but its matrix products and convolutions run at
another batch size, and the CPU's BLAS rounds some of them differently
(float32 last bits).  Sums over those bits agree to ~1e-7 of their size; a
leaky ReLU whose input lands within a rounding of 0 switches slope at one
element, which moves a few leaves' gradients (a layer's noise strength,
bias, weight) by up to ~1e-3 of their size but the network's whole
gradient by < 1e-5 of its norm: the step is held there, per network.
"""

import json
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from shgan_torch.parallel import (Rows, ThreadGroup, check_replicated,
                                  create_mesh, split)
from shgan_torch.parallel.multihost import pick_backend
from mh_launch import Ranks, rank_env

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(HERE)
RANK_SCRIPT = osp.join(HERE, "torch_mh_driver.py")


def _env():
    return rank_env(2)


def _run(mode, out_dir, world):
    """``mode`` of ``torch_mh_driver.py`` on ``world`` ranks (1: one
    process, port 0 unused); returns each rank's output, after every rank
    exited 0 (``mh_launch``: a port reserved for the run, the first failed
    rank ends it)."""
    return Ranks(RANK_SCRIPT, world, [out_dir, mode], out_dir, _env(),
                 timeout=300).wait()


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_collectives_gather_bytes_and_name_a_skewed_replica(tmp_path):
    outs = _run("collectives", str(tmp_path), 2)
    for r, out in enumerate(outs):
        assert f"MH_SKEW_NAMED {r}" in out and f"MH_COLLECTIVES_OK {r}" in out


def test_train_step_on_two_ranks_equals_one(tmp_path):
    """One TrainStep (Gpl and R1, random noise, style mixing and the
    encoder's dropout on) on 2 ranks x 4 rows against 1 rank x 8 rows."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    _run("step", one, 1)
    _run("step", two, 2)
    a = _npz(osp.join(one, "step_rank0.npz"))
    b0 = _npz(osp.join(two, "step_rank0.npz"))
    b1 = _npz(osp.join(two, "step_rank1.npz"))
    # the ranks hold the same bits (each rank ran check_replicated too)
    for k in b0:
        np.testing.assert_array_equal(b0[k], b1[k], err_msg=k)
    for net in ("G", "D"):
        keys = [k for k in a if k.startswith(net + "0_")]
        assert keys
        diff = np.sqrt(sum(np.sum((a[k] - b0[k]) ** 2) for k in keys))
        norm = np.sqrt(sum(np.sum(a[k] ** 2) for k in keys))
        assert diff <= 1e-5 * norm, (net, diff / norm)
    np.testing.assert_allclose(b0["w_avg"], a["w_avg"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(b0["pl_mean"], a["pl_mean"], rtol=1e-6)
    assert float(a["pl_mean"]) > 0


def test_eval_stage_on_two_ranks_matches_one(tmp_path):
    """``eval_stage`` over 10 images (the last batch padded), random noise
    reaching the image: JAX's multihost bounds (psnr 0.02, ssim 0.002);
    the pre-generated protocol over the ranks on the same pairs;
    ``result.json`` from the lead only."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    _run("eval", one, 1)
    _run("eval", two, 2)
    with open(osp.join(one, "eval_log0", "result.json")) as f:
        single = json.load(f)
    with open(osp.join(two, "eval_log0", "result.json")) as f:
        double = json.load(f)
    assert not osp.exists(osp.join(two, "eval_log1", "result.json"))
    assert set(single) == set(double) == {"psnr", "ssim"}
    assert abs(single["psnr"]["psnr"] - double["psnr"]["psnr"]) < 0.02
    assert abs(single["ssim"]["ssim"] - double["ssim"]["ssim"]) < 0.002
    with open(osp.join(one, "eval_rv0.json")) as f:
        pre1 = json.load(f)["pregen"]
    with open(osp.join(two, "eval_rv1.json")) as f:
        rv1 = json.load(f)
    # every rank returns the gathered metrics
    assert rv1["gen"] == {"psnr": double["psnr"]["psnr"],
                          "ssim": double["ssim"]["ssim"]}
    # pre-generated images: the same pairs, whatever the ranks
    assert rv1["pregen"]["psnr"] == pytest.approx(pre1["psnr"], rel=1e-12)
    assert rv1["pregen"]["ssim"] == pytest.approx(pre1["ssim"], rel=1e-9)
    assert not osp.exists(osp.join(two, "eval_log1_pregen", "result.json"))
    assert osp.isfile(osp.join(two, "eval_log0_pregen", "result.json"))


def test_train_stage_on_two_ranks_snapshots_once_and_resumes(tmp_path):
    """``train_stage`` across snapshot ticks on 2 ranks, then a resume on
    both from the lead's snapshot; the lead alone writes, and its
    ``stats.jsonl`` holds the 1-rank run's losses."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    _run("train", one, 1)
    outs = _run("train", two, 2)
    for r, out in enumerate(outs):
        assert f"MH_TRAIN_RESUME_OK {r}" in out
    lead = osp.join(two, "train_log0")
    assert osp.isfile(osp.join(lead, "demo", "fakes_init.png"))
    assert osp.isdir(osp.join(lead, "weight", "network-snapshot-000000"))
    assert not osp.exists(osp.join(two, "train_log1"))

    def records(d):
        with open(osp.join(d, "train_log0", "stats.jsonl")) as f:
            return [json.loads(line) for line in f]
    r1, r2 = records(one), records(two)
    assert [r["step"] for r in r1] == [r["step"] for r in r2] == [
        8, 16, 24]
    for a, b in zip(r1, r2):
        for k in ("loss_g", "loss_d", "scores_real", "scores_fake_d"):
            assert b[k] == pytest.approx(a[k], rel=1e-4, abs=1e-6), k


def _tiny_engine_cfg(log_root):
    from shgan_torch.main import build_config
    return build_config("smoke_train", log_root=str(log_root))["model_g"]


@pytest.mark.parametrize("noise_mode", ["const", "random"])
def test_engine_over_two_cpu_devices_equals_one(noise_mode, tmp_path):
    from shgan_torch.serve import InpaintEngine
    cfg = _tiny_engine_cfg(tmp_path)
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (7, 3, 32, 32)).astype(np.uint8)
    masks = rng.rand(7, 32, 32) > 0.4
    outs = []
    for mesh in (None, ["cpu", "cpu"]):
        e = InpaintEngine(cfg, batch_size=4, noise_mode=noise_mode, seed=3,
                          device="cpu", mesh=mesh, latency_batches=(2,))
        with torch.no_grad():
            for name, p in e.G.named_parameters():
                if name.endswith("noise_strength"):
                    p.fill_(0.2)
            for G in e.replicas.values():
                G.load_state_dict(e.G.state_dict())
        outs.append(e.inpaint(imgs, masks, start_index=5))
        outs.append(np.concatenate(list(e.inpaint_stream(
            [(imgs[:4], masks[:4]), (imgs[4:], masks[4:])]))))
    np.testing.assert_array_equal(outs[2], outs[0])
    np.testing.assert_array_equal(outs[3], outs[1])
    with pytest.raises(ValueError, match="divisible"):
        InpaintEngine(cfg, batch_size=3, device="cpu", mesh=["cpu", "cpu"])


def test_thread_group_gathers_in_row_order_and_aborts():
    import threading
    g = ThreadGroup(2)
    got = [None, None]

    def work(k):
        got[k] = g.gather_rows(torch.full((2, 3), float(k)),
                               Rows(2 * k, 2 * k + 2, 4, g))
    ts = [threading.Thread(target=work, args=(k,)) for k in (1, 0)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    assert all(not t.is_alive() for t in ts)
    for out in got:
        assert out[:, 0].tolist() == [0, 0, 1, 1]
    g.abort()
    with pytest.raises(threading.BrokenBarrierError):
        g.gather_rows(torch.zeros(1, 1), Rows(0, 1, 2, g))


def test_one_process_mesh_and_backend_rule():
    mesh = create_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.model) == (1, 0, 1)
    assert mesh.rows(8) is None and mesh.batch_rows(8) == list(range(8))
    assert check_replicated(torch.nn.Linear(2, 2)) == 2
    assert split(8, 2, 1) == (4, 8)
    with pytest.raises(ValueError, match="does not split"):
        split(7, 2, 0)
    one = [("h", "cuda:0"), ("h", "cuda:1")]
    assert pick_backend(one) == "nccl"
    assert pick_backend([("h", "cuda:0"), ("h", "cuda:0")]) == "gloo"
    assert pick_backend([("h", "cpu"), ("h", "cpu")]) == "gloo"
    assert pick_backend(one, "gloo") == "gloo"
    with pytest.raises(ValueError, match="duplicate GPU"):
        pick_backend([("h", "cuda:0"), ("h", "cuda:0")], "nccl")
    with pytest.raises(ValueError, match="CUDA device"):
        pick_backend([("h", "cpu")], "nccl")


JAX_MBSTD = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
from shgan_tpu.checkpoint import params_to_flat_state_dict
from shgan_tpu.models import get_model
from shgan_tpu.runtime.config import experiment_cfg_bank

assert len(jax.devices()) == 2, jax.devices()
D = get_model(experiment_cfg_bank()("smoke_train")["model_d"])
params = D.init(jax.random.key(3))
x = np.random.RandomState(8).randn(8, 4, 32, 32).astype(np.float32)

def r1(p, x):
    g = jax.grad(lambda x: D(p, x).sum())(x)
    return (jnp.square(g).sum(axis=(1, 2, 3))).mean() * 5.0

fwd = jax.jit(D)
grad_x = jax.jit(jax.grad(lambda p, x: D(p, x).sum(), argnums=1))
grad_p = jax.jit(jax.grad(r1))
mesh = Mesh(np.asarray(jax.devices()), ("data",))
xs = jax.device_put(x, NamedSharding(mesh, P("data")))
assert len(xs.addressable_shards) == 2
out = {"x": x}
for tag, xin in (("one", x), ("mesh", xs)):
    out[f"logits_{tag}"] = np.asarray(fwd(params, xin))
    out[f"r1_{tag}"] = np.asarray(grad_x(params, xin))
    for k, v in params_to_flat_state_dict(grad_p(params, xin)).items():
        out[f"g_{tag}:{k}"] = np.asarray(v)
# the per-device reading of the docstring: each half's own groups
out["logits_halves"] = np.concatenate([np.asarray(fwd(params, x[:4])),
                                       np.asarray(fwd(params, x[4:]))])
for k, v in params_to_flat_state_dict(params).items():
    out["p:" + k] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def test_minibatch_stddev_spans_the_global_batch(tmp_path):
    """JAX's discriminator on a 2-device mesh computes the minibatch stddev
    over the global batch (the groups span the devices), not per device
    as ``shgan_tpu/ops/minibatch_std.py`` says; the port's D on 2 ranks
    matches it: logits, R1's input gradient and R1's weight gradient."""
    ref = str(tmp_path / "jax_d.npz")
    env = dict(_env(), JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_MBSTD, ref, REPO],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    j = _npz(ref)
    np.testing.assert_allclose(j["logits_mesh"], j["logits_one"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(j["r1_mesh"], j["r1_one"], rtol=1e-5,
                               atol=1e-7)
    assert np.abs(j["logits_halves"] - j["logits_one"]).max() > 1e-4

    _run("mbstd", str(tmp_path), 2)
    t = [_npz(str(tmp_path / f"mbstd_rank{r}.npz")) for r in (0, 1)]
    np.testing.assert_allclose(
        np.concatenate([t[0]["logits"], t[1]["logits"]]), j["logits_one"],
        rtol=1e-5, atol=1e-5)
    r1 = np.concatenate([t[0]["r1"], t[1]["r1"]])
    np.testing.assert_allclose(r1, j["r1_one"], rtol=1e-4,
                               atol=1e-5 * np.abs(j["r1_one"]).max())
    from shgan_torch.checkpoint import params_from_jax
    want = params_from_jax({k[6:]: v for k, v in j.items()
                            if k.startswith("g_one:")})
    for k, v in want.items():
        v = np.asarray(v)
        got = t[0]["g:" + k]
        np.testing.assert_array_equal(got, t[1]["g:" + k])
        np.testing.assert_allclose(got, v, rtol=1e-3,
                                   atol=1e-4 * np.abs(v).max() + 1e-12,
                                   err_msg=k)


def _cli(args, tmp_path):
    env = dict(_env(), SHGAN_LOG_ROOT=str(tmp_path))
    return subprocess.run([sys.executable, "-m", "shgan_torch.main", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)


def test_cli_spawns_a_rank_per_gpu_entry(tmp_path):
    """``--gpu 0 0 --device cpu``: two CPU ranks from one command, the
    lead's run id and ``result.json``; a rank that fails fails the CLI."""
    r = _cli(["--experiment", "shgan_synthetic256_eval", "--debug", "--eval",
              "0", "--device", "cpu", "--gpu", "0", "0", "--pick",
              "syn00000", "syn00001", "syn00002"], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    run_dir = tmp_path / "shgan_synthetic256_inpainting" / "0" \
        / "shgan_synthetic256"
    with open(run_dir / "result.json") as f:
        res = json.load(f)
    assert np.isfinite(res["psnr"]["psnr"])
    assert "2 ranks" in (run_dir / "eval.log").read_text()
    bad = _cli(["--experiment", "shgan_synthetic256_eval", "--eval", "1",
                "--device", "cpu", "--gpu", "0", "0", "--pretrained",
                str(tmp_path / "missing.pth")], tmp_path)
    assert bad.returncode != 0
    assert "missing.pth" in bad.stdout + bad.stderr
