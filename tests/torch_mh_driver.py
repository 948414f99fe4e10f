"""One rank of a multi-process run of shgan_torch on the CPU (gloo), for
tests/test_torch_parallel.py.

Usage: python torch_mh_driver.py <rank> <world> <port> <out_dir> <mode>

With ``world`` > 1 the rank joins the group through the ``SHGAN_DIST_*``
variables, as ``python -m shgan_torch.main`` ranks do; ``world`` 1 is the
one-process reference.  Every mode runs at ``smoke_train``'s 32² plan and
writes what the test compares into ``out_dir`` (rank 0, or every rank where
the test needs each one):

* ``collectives``: ``allgather_rows`` on float64, bool and ragged rows;
  ``check_replicated`` on equal ranks and on a skewed parameter;
* ``step``: one ``TrainStep`` (both regularizers, random noise, style
  mixing and dropout on) over the global batch of 8: each network's
  averaged gradients, ``w_avg``, ``pl_mean`` and the weights after it;
* ``eval``: ``eval_stage`` over 10 synthetic images (psnr, ssim), then
  over 10 pre-generated PNGs (``--evalnog_path``'s loadgen pairing);
* ``train``: ``train_stage`` across snapshot ticks, then a resume;
* ``engine``: nothing distributed: the engine over two CPU "devices";
* ``mbstd``: D's logits and R1's gradient on the global batch.

It imports nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

rank, world, port, out_dir, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
if world > 1:
    os.environ["SHGAN_DIST_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["SHGAN_DIST_NPROCS"] = str(world)
    os.environ["SHGAN_DIST_PID"] = str(rank)
torch.set_num_threads(2)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from shgan_torch.parallel import (allgather_rows, barrier,  # noqa: E402
                                  check_replicated, create_mesh,
                                  maybe_initialize_distributed)

maybe_initialize_distributed(device="cpu")
mesh = create_mesh(device="cpu")

from shgan_torch.main import build_config  # noqa: E402
from shgan_torch.models.registry import get_model  # noqa: E402
from shgan_torch.data.rng import derive_seed  # noqa: E402

BATCH = 8


def save(name, **arrays):
    np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), **arrays)


def models(seed=0):
    cfg = build_config("smoke_train", log_root=os.path.join(out_dir, "log"))
    G = get_model(cfg["model_g"], seed=seed)
    D = get_model(cfg["model_d"], seed=derive_seed(seed, 1))
    with torch.no_grad():   # the noise reaches the image, biases move it
        for name, p in list(G.named_parameters()) + list(
                D.named_parameters()):
            if name.endswith("noise_strength"):
                p.fill_(0.1)
            elif name.endswith(".bias"):
                p.add_(0.05)
    return cfg, G, D


def global_batch(seed=3):
    rng = np.random.RandomState(seed)
    real = rng.randn(BATCH, 3, 32, 32).astype(np.float32).clip(-1, 1)
    mask = (rng.rand(BATCH, 1, 32, 32) > 0.4).astype(np.float32)
    return torch.from_numpy(real), torch.from_numpy(mask)


if mode == "collectives":
    f64 = (np.arange(3, dtype=np.float64) + rank * 3) * (1 + 1e-12)
    got = allgather_rows(f64)
    want = np.arange(world * 3, dtype=np.float64) * (1 + 1e-12)
    assert got.dtype == np.float64 and np.array_equal(got, want), got
    b = allgather_rows(np.asarray([rank % 2 == 0, True]))
    assert b.dtype == np.bool_ and b.tolist() == [True, True, False, True]
    ragged = allgather_rows(np.full((rank + 1, 2, 3), rank, np.int16))
    assert ragged.shape == (3, 2, 3) and ragged[1:].tolist() == (
        np.ones((2, 2, 3)).tolist()), ragged
    empty = allgather_rows(np.zeros((0, 4), np.float32))
    assert empty.shape == (0, 4)
    _, G, D = models()
    assert check_replicated([G, D]) == len(list(G.parameters())) + len(
        list(G.buffers())) + len(list(D.parameters())) + len(
        list(D.buffers()))
    if rank == 1:
        with torch.no_grad():
            G.synthesis.b8.conv1.weight[0, 0, 0, 0] += 1e-7
    try:
        check_replicated(G)
    except AssertionError as e:
        assert "synthesis.b8.conv1.weight" in str(e), e
        print("MH_SKEW_NAMED", rank, flush=True)
    else:
        raise AssertionError("a skewed parameter passed check_replicated")
    print("MH_COLLECTIVES_OK", rank, flush=True)

elif mode == "step":
    from shgan_torch.train import TrainConfig, TrainStep
    from shgan_torch.runtime.stages import step_generator
    cfg, G, D = models()
    step = TrainStep(G, D, TrainConfig(
        **(cfg["train"].get("loss_kwargs") or {})), mesh=mesh)
    grads = {}

    def recording(opt, net):
        inner = opt.step

        def wrapped(*a, **kw):
            for i, group in enumerate(opt.param_groups):
                for j, p in enumerate(group["params"]):
                    grads[f"{net}{i}_{j}"] = p.grad.detach().clone().numpy()
            return inner(*a, **kw)
        opt.step = wrapped

    recording(step.opt_g, "G")
    recording(step.opt_d, "D")
    real, mask = mesh.shard_batch(global_batch())
    step(real, mask, step_generator(0, 0), 0.99, do_greg=True, do_dreg=True)
    check_replicated([step.G, step.D, step.G_ema, step.pl_mean])
    save("step", w_avg=G.mapping.w_avg.numpy(), pl_mean=step.pl_mean.numpy(),
         **grads, **{f"W_{k}": v.detach().numpy()
                     for k, v in G.state_dict().items()})
    print("MH_STEP_OK", rank, flush=True)

elif mode == "eval":
    from shgan_torch.runtime.stages import eval_stage
    cfg, G, _ = models()
    pth = os.path.join(out_dir, "g.pth")
    if rank == 0:
        torch.save(G.state_dict(), pth)
    barrier()
    # rank 1 gets a log dir of its own: the test holds that it writes none
    log_dir = os.path.join(out_dir, f"eval_log{rank}")
    ecfg = {
        "env": {"rnd_seed": 7},
        "model_g": cfg["model_g"],
        "eval": {
            "dataset": {
                "type": "synthetic", "name": "syn32",
                "args": {"resolution": 32, "length": 10, "seed": 3},
                "formatter": {"type": "RandomMaskFormatter",
                              "args": {"random_flip": False,
                                       "mask_resolution": 32,
                                       "hole_range": [0, 1],
                                       "impl": "numpy"}}},
            "evaluator": [{"type": "psnr", "args": {"for_dataset": None,
                                                    "rgb_range": 1}},
                          {"type": "ssim", "args": {"window_size": 11}}],
            "batch_size_per_gpu": 4 // world,
            "dataset_num_workers": 0, "log_dir": log_dir,
            "log_display": 100, "noise_mode": "random",
            "pretrained_pth": pth, "strict_sd": True}}
    rv = eval_stage()(ecfg, device="cpu")
    # the pre-generated protocol over the ranks: 10 (real, PNG) pairs
    gen = os.path.join(out_dir, "gen")
    if rank == 0:
        from PIL import Image
        os.makedirs(gen, exist_ok=True)
        rng = np.random.RandomState(5)
        for i in range(10):
            Image.fromarray(rng.randint(0, 256, (32, 32, 3)).astype(
                np.uint8)).save(os.path.join(gen, f"syn{i:05d}.png"))
    barrier()
    ecfg["eval"]["dataset"] = {"type": "loadgen", "args": {
        "base": {"type": "synthetic", "args": {"resolution": 32,
                                               "length": 10, "seed": 3}},
        "gen_dir": gen}}
    ecfg["eval"]["log_dir"] = log_dir + "_pregen"
    pre = eval_stage()(ecfg, device="cpu")
    import json
    with open(os.path.join(out_dir, f"eval_rv{rank}.json"), "w") as f:
        json.dump({"gen": rv["eval_rv"], "pregen": pre["eval_rv"]}, f)
    print("MH_EVAL_OK", rank, rv["eval_rv"], flush=True)

elif mode == "train":
    from shgan_torch.main import run
    log_dir = os.path.join(out_dir, f"train_log{rank}")

    def train_cfg(total_kimg, resume=None):
        cfg = build_config("smoke_train", overrides={
            "train.total_kimg": total_kimg, "train.snapshot_ticks": 1,
            "train.image_snapshot_ticks": 2, "train.log_dir": log_dir,
            "train.resume_path": resume, "env.mesh_devices": None},
            log_root=os.path.join(out_dir, f"log{rank}"))
        cfg["train"]["log_dir"] = log_dir
        return cfg

    rv = run(train_cfg(0.016), device="cpu")        # 2 steps, 2 ticks
    assert rv["step"].step == 2, rv["step"].step
    snap = os.path.join(out_dir, "train_log0", "weight",
                        "network-snapshot-000000")
    print("MH_TRAIN_SNAPSHOT_OK", rank, flush=True)
    rv = run(train_cfg(0.024, resume=snap), device="cpu")   # 1 more
    assert rv["step"].step == 3, rv["step"].step
    check_replicated([rv["step"].G, rv["step"].D, rv["step"].G_ema])
    print("MH_TRAIN_RESUME_OK", rank, flush=True)

elif mode == "mbstd":
    # D's logits and R1's gradient on the global batch the JAX subprocess
    # scored, with its weights
    from shgan_torch.checkpoint import params_from_jax
    ref = np.load(os.path.join(out_dir, "jax_d.npz"))
    cfg = build_config("smoke_train", log_root=os.path.join(out_dir, "log"))
    D = get_model(cfg["model_d"], seed=0)
    D.load_state_dict(params_from_jax(
        {k[2:]: ref[k] for k in ref.files if k.startswith("p:")}),
        strict=True)
    x = mesh.shard_batch(torch.from_numpy(ref["x"]))
    rows = mesh.rows(ref["x"].shape[0])
    x.requires_grad_(True)
    logits = D(x, rows=rows)
    r1, = torch.autograd.grad(logits.sum(), x, create_graph=True)
    # R1's loss and the gradient of D's weights through it (the second
    # order goes back through the gather)
    loss = r1.square().sum(dim=(1, 2, 3)).mean() * 5.0
    loss.backward()
    dgrad = {f"g:{k}": (p.grad.clone() if p.grad is not None
                        else torch.zeros_like(p))
             for k, p in D.named_parameters()}
    for t in dgrad.values():
        mesh.all_reduce_mean_(t)
    save("mbstd", logits=logits.detach().numpy(), r1=r1.detach().numpy(),
         **{k: v.numpy() for k, v in dgrad.items()})
    print("MH_MBSTD_OK", rank, flush=True)
