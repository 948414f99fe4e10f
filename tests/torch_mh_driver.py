"""One rank of a multi-process run of shgan_torch on the CPU (gloo), for
tests/test_torch_parallel.py.

Usage: python torch_mh_driver.py <rank> <world> <port> <out_dir> <mode>
       [<model>]

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
* ``mbstd``: D's logits and R1's gradient on the global batch;
* ``remat_step``: the ``step`` mode's step with remat on, against the
  ranks' step without it and one process's step on the global batch;
* ``dp_reference``: one ``TrainStep`` (Gpl, R1) of the benchmark's tiny
  training configuration (``benchmark/tests/tiny.py``) on the benchmark's
  seeded weights, each rank on its rows of a global batch of 8: the ranks'
  mean of the losses (as the train stage logs them), Adam's first
  ``exp_avg`` and every tensor of the state after the step, for the plain
  reference (``benchmark/reference/training.py``) the test runs;
* ``dp_spans``: one ``TrainStep`` (Gpl, R1) under a CPU profiler: the
  ``dist.grads`` and ``dist.rows`` spans it recorded and the mesh's
  counters.

With ``model`` (default 1) the mesh has a model axis of that many ranks,
and the spatial modes (for tests/test_torch_spatial.py) run G's levels on
slabs, each rank holding the unsharded reference it computes itself:

* ``spatial_ops``: each op of a sharded level on slabs (forward, backward,
  second order) against the unsharded op;
* ``spatial_g``: the generator of ``__graft_entry__.py`` (res 64,
  ``ch_max`` 8) at ``min_res`` 16, const and random noise;
* ``spatial_jax``: that generator on the JAX weights the test wrote;
* ``spatial_step``: one ``TrainStep`` (Gmain + Gpl + Dmain + R1) sharded
  against the one-process step (``model`` 1: inside the context against
  outside it);
* ``spatial_remat``: that sharded step with remat on against it without
  remat, and a G forward under the sharding with its backward outside it.

It imports nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

rank, world, port, out_dir, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
MODEL = int(sys.argv[6]) if len(sys.argv) > 6 else 1
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

# a rank that cannot reach its peers fails within the test's time
maybe_initialize_distributed(device="cpu", timeout_s=240)
mesh = create_mesh(device="cpu", model=MODEL)

from shgan_torch.main import build_config  # noqa: E402
from shgan_torch.models.registry import get_model  # noqa: E402
from shgan_torch.data.rng import derive_seed  # noqa: E402

BATCH = 8
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# the dp_reference mode's seed: weights, batch and the step's draws
DP_SEED = 2 ** 31 + 5


def recording(opt, net, grads):
    """Make ``opt.step`` first copy each parameter's gradient, as the
    optimizer reads it, into ``grads`` (keyed ``<net><group>_<index>``)."""
    inner = opt.step

    def wrapped(*a, **kw):
        for i, group in enumerate(opt.param_groups):
            for j, p in enumerate(group["params"]):
                grads[f"{net}{i}_{j}"] = p.grad.detach().clone().numpy()
        return inner(*a, **kw)
    opt.step = wrapped


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


def dp_batch():
    """The ``dp_reference`` mode's global batch: photo-like images and
    free-form masks of the benchmark's inputs, at 32²."""
    from harness import inputs
    rng = np.random.RandomState(DP_SEED)
    real = np.stack([inputs.photo(rng, 32) for _ in range(BATCH)])
    mask = np.stack([inputs.free_form_mask(rng, 32) for _ in range(BATCH)])
    return (torch.from_numpy(real.astype(np.float32) / 127.5 - 1),
            torch.from_numpy(mask[:, None].astype(np.float32)))


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
    recording(step.opt_g, "G", grads)
    recording(step.opt_d, "D", grads)
    real, mask = mesh.shard_batch(global_batch())
    step(real, mask, step_generator(0, 0), 0.99, do_greg=True, do_dreg=True)
    check_replicated([step.G, step.D, step.G_ema, step.pl_mean])
    save("step", w_avg=G.mapping.w_avg.numpy(), pl_mean=step.pl_mean.numpy(),
         **grads, **{f"W_{k}": v.detach().numpy()
                     for k, v in G.state_dict().items()})
    print("MH_STEP_OK", rank, flush=True)

elif mode == "remat_step":
    from shgan_torch.train import TrainConfig, TrainStep
    from shgan_torch.runtime.stages import step_generator
    out = {}
    for name, step_mesh, remat in (("one", None, False),
                                   ("plain", mesh, False),
                                   ("remat", mesh, True)):
        cfg, G, D = models()
        for m in (G.encoder, G.synthesis, D):
            m.remat = remat
        step = TrainStep(G, D, TrainConfig(
            **(cfg["train"].get("loss_kwargs") or {})), mesh=step_mesh)
        grads = {}
        recording(step.opt_g, "G", grads)
        recording(step.opt_d, "D", grads)
        real, mask = global_batch()
        if step_mesh is not None:
            real, mask = mesh.shard_batch((real, mask))
        step(real, mask, step_generator(0, 0), 0.99, do_greg=True,
             do_dreg=True)
        if step_mesh is not None:
            check_replicated([step.G, step.D, step.G_ema, step.pl_mean])
        arrays = dict(grads, w_avg=G.mapping.w_avg.numpy(),
                      pl_mean=step.pl_mean.numpy(),
                      **{f"W_{k}": v.detach().numpy()
                         for k, v in G.state_dict().items()})
        out.update({f"{name}_{k}": v for k, v in arrays.items()})
    save("remat_step", **out)
    print("MH_REMAT_STEP_OK", rank, flush=True)

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

elif mode == "dp_reference":
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    from shgan_torch.train.step import compute_ema_beta
    sys.path.insert(0, os.path.join(REPO, "benchmark", "tests"))
    import tiny  # noqa: E402  (puts the benchmark's directory on the path)
    from harness import inputs  # noqa: E402
    cfg = tiny.tiny_train()
    nets = {}
    for name, seed in (("model_g", DP_SEED), ("model_d", DP_SEED + 1)):
        net = get_model(cfg[name], seed=seed)
        tmpl = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in net.state_dict().items()}
        net.load_state_dict(inputs.weights(tmpl, cfg[name], seed,
                                           torch.device("cpu")), strict=True)
        nets[name] = net
    G, D = nets["model_g"], nets["model_d"]
    tc = TrainConfig(**cfg["train"]["loss_kwargs"])
    step = TrainStep(G, D, tc, mesh=mesh)
    real, mask = dp_batch()
    m = step(*mesh.shard_batch((real, mask)), step_generator(DP_SEED, 0),
             compute_ema_beta(tc, BATCH, 0), do_greg=True, do_dreg=True)
    keys = sorted(m)
    loss = mesh.all_reduce_mean_(torch.stack([m[k].float() for k in keys]))
    first = {f"F_{net}.{name}": opt.state[p]["exp_avg"].numpy()
             for net, opt, mod in (("G", step.opt_g, G), ("D", step.opt_d, D))
             for name, p in mod.named_parameters() if p in opt.state}
    check_replicated([step.G, step.D, step.G_ema, step.pl_mean])
    state = {**{"G." + k: v for k, v in G.state_dict().items()},
             **{"D." + k: v for k, v in D.state_dict().items()},
             **{"G_ema." + k: v for k, v in step.G_ema.state_dict().items()}}
    save("dp_reference", **first, pl_mean=step.pl_mean.numpy(),
         seed=np.int64(DP_SEED), real=real.numpy(), mask=mask.numpy(),
         **{f"L_{k}": v for k, v in zip(keys, loss.numpy())},
         **{f"S_{k}": v.detach().numpy() for k, v in state.items()})
    print("MH_DP_REFERENCE_OK", rank, flush=True)

elif mode == "dp_spans":
    from torch.profiler import ProfilerActivity, profile
    from shgan_torch.runtime import tracing
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    from shgan_torch.train.step import freeze_buffers
    cfg, G, D = models()
    step = TrainStep(G, D, TrainConfig(
        **(cfg["train"].get("loss_kwargs") or {})), mesh=mesh)
    real, mask = mesh.shard_batch(global_batch())
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        step(real, mask, step_generator(0, 0), 0.99, do_greg=True,
             do_dreg=True)
    recs = tracing.spans()
    import json
    with open(os.path.join(out_dir, f"{mode}_rank{rank}.json"), "w") as f:
        json.dump({
            "traffic": mesh.traffic,
            "steps": sum(r.name == "train.step" for r in recs),
            "grads": [r.attrs["bytes"] for r in recs
                      if r.name == "dist.grads"],
            "rows": [r.attrs["bytes"] for r in recs
                     if r.name == "dist.rows"],
            "params": sum(p.numel() for net in (G, D)
                          for p in freeze_buffers(net))}, f)
    print("MH_DP_SPANS_OK", rank, flush=True)

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

# ---------------------------------------------------------------------------
# spatial sharding (tests/test_torch_spatial.py)
# ---------------------------------------------------------------------------

ACT = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"


def graft_models(seed=0):
    """The generator and discriminator of ``__graft_entry__.py:134-155``
    (res 64, ``ch_max`` 8, ``shu_input_res`` 16) in the port."""
    res = 64
    enc = dict(
        resolution=res, ic_n=4, oc_n=32, ch_base=256, ch_max=8,
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
                      "args": dict(w_dim=32, w0_dim=32, resolution=res,
                                   rgb_n=3, ch_base=256, ch_max=8,
                                   use_fp16_after_res=None,
                                   activation=ACT)}}}, seed=seed)
    D = get_model({"type": "comodgan_discriminator",
                   "args": dict(resolution=res, ic_n=4, ch_base=256,
                                ch_max=8, use_fp16_before_res=None,
                                activation=ACT)},
                  seed=derive_seed(seed, 1))
    return G, D


def graft_batch(n=4):
    """``__graft_entry__.py``'s draws: real, mask (and z) from seed 0."""
    rng = np.random.RandomState(0)
    real = rng.randn(n, 3, 64, 64).astype(np.float32)
    mask = (rng.rand(n, 1, 64, 64) > 0.5).astype(np.float32)
    z = rng.randn(n, 32).astype(np.float32)
    return torch.from_numpy(real), torch.from_numpy(mask), torch.from_numpy(z)


def max_err(a, b):
    return float((a.detach().double() - b.detach().double()).abs().max())


def save_json(name, obj):
    import json
    with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(obj, f)


def spatial_ops():
    from shgan_torch.models.layers import SynthesisLayer, ToRGBLayer
    from shgan_torch.ops.conv_resample import conv2d_resample
    from shgan_torch.ops.upfirdn2d import setup_filter, upsample2d
    from shgan_torch.parallel import spatial
    mesh.traffic.update(halo_bytes=0, sum_bytes=0)
    fir = setup_filter([1, 3, 3, 1])
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    w3 = (rnd(5, 3, 3, 3) * 0.3).requires_grad_(True)
    w1 = (rnd(5, 3, 1, 1) * 0.5).requires_grad_(True)
    gain = torch.tensor([0.7], requires_grad=True)
    ws = rnd(2, 4).requires_grad_(True)
    syn_up = SynthesisLayer(3, 5, 3, w_dim=4, resolution=16, up=2,
                            layer_id=32, generator=gen)
    syn = SynthesisLayer(3, 5, 3, w_dim=4, resolution=16, layer_id=33,
                         generator=gen)
    rgb = ToRGBLayer(3, 3, 1, w_dim=4, generator=gen)
    with torch.no_grad():
        for m in (syn_up, syn, rgb):
            m.bias.add_(0.1)
        syn_up.noise_strength.fill_(0.3)
        syn.noise_strength.fill_(0.2)
    # name: (input rows, output rows, op(x, slab, src), parameters): the
    # parameters are every replicated leaf; the input planes of the plain
    # ops are 12 wide (H != W), a synthesis layer's square
    cases = {
        "conv3x3": (16, 16, lambda x, s, src: conv2d_resample(
            x, w3, padding=1, slab=s, src=src), [w3]),
        "conv1x1": (16, 16, lambda x, s, src: conv2d_resample(
            x, w1, slab=s, src=src), [w1]),
        "down2": (16, 8, lambda x, s, src: conv2d_resample(
            x, w3, f=fir, down=2, padding=1, slab=s, src=src), [w3]),
        "up2": (8, 16, lambda x, s, src: conv2d_resample(
            x, w3, f=fir, up=2, padding=1, flip_weight=False, slab=s,
            src=src), [w3]),
        "upsample2d": (8, 16, lambda x, s, src: upsample2d(
            x * spatial.replicated(gain, src)[:, None, None, None], fir,
            slab=s, src=src), [gain]),
        "synthesis_up_random": (8, 16, lambda x, s, src: syn_up(
            x, ws, noise_mode="random", noise_seed=11, slab=s, src=src),
            list(syn_up.parameters()) + [ws]),
        "synthesis_const": (16, 16, lambda x, s, src: syn(
            x, ws, noise_mode="const", slab=s, src=src),
            list(syn.parameters()) + [ws]),
        "torgb": (16, 16, lambda x, s, src: rgb(x, ws, slab=s),
                  list(rgb.parameters()) + [ws]),
    }
    errs = {}
    for name, (hin, hout, op, params) in cases.items():
        for whole_in in ((False, True) if hin != hout else (False,)):
            wd = hin if name.startswith(("synthesis", "torgb")) else 12
            X = rnd(2, 3, hin, wd).requires_grad_(True)
            leaves = [X] + [p for p in params if p.requires_grad]
            for p in leaves[1:]:
                p.grad = None
            with torch.no_grad():
                C = rnd(*op(X, None, None).shape)

            def run(sharded):
                if not sharded:
                    y = op(X, None, None)
                else:
                    s_in = None if whole_in else spatial.level(hin)
                    s_out = (spatial.level(hout) if s_in is None
                             else s_in.scaled(hout))
                    x = X if s_in is None else s_in.take(X)
                    y = s_out.gather(op(x, s_out, s_in))
                loss = (y * C).sum()
                g1 = torch.autograd.grad(loss, leaves, create_graph=True)
                l2 = sum((g * g).sum() for g in g1)
                g2 = torch.autograd.grad(l2, leaves, allow_unused=True)
                return [y] + list(g1) + [g if g is not None else
                                         torch.zeros_like(p)
                                         for g, p in zip(g2, leaves)]
            want = run(False)
            with spatial.spatial_sharding(mesh, min_res=1):
                got = run(True)
            tag = name + ("_from_whole" if whole_in else "")
            k = len(leaves)
            errs[tag] = {
                order: (max(max_err(a, b) for a, b in zip(got[sl], want[sl])),
                        max(float(t.detach().abs().max()) for t in want[sl]))
                for order, sl in (("forward", slice(0, 1)),
                                  ("backward", slice(1, 1 + k)),
                                  ("second", slice(1 + k, None)))}
    save_json("spatial_ops", {"errs": errs, "transport": mesh.transport,
                              "traffic": mesh.traffic})
    print("MH_SPATIAL_OPS_OK", rank, flush=True)

def spatial_g(mode):
    from shgan_torch.parallel import spatial
    mesh.traffic.update(halo_bytes=0, sum_bytes=0)
    G, _ = graft_models()
    real, mask, z = graft_batch()
    x = torch.cat([mask - 0.5, real * mask], dim=1)
    if mode == "spatial_jax":
        from shgan_torch.checkpoint import params_from_jax
        ref = np.load(os.path.join(out_dir, "jax_g.npz"))
        G.load_state_dict(params_from_jax(
            {k[2:]: ref[k] for k in ref.files if k.startswith("p:")}),
            strict=True)
        x, z = torch.from_numpy(ref["x"]), torch.from_numpy(ref["z"])
    G.requires_grad_(False)
    out = {}
    for noise in (("const",) if mode == "spatial_jax"
                  else ("const", "random")):
        kw = dict(noise_mode=noise, noise_seed=77)
        want = G(x, z, **kw)
        rows = mesh.rows(x.shape[0])
        xs, zs = mesh.shard_batch(x), mesh.shard_batch(z)
        with spatial.spatial_sharding(mesh, min_res=16):
            got = G(xs, zs, rows=rows,
                    row0=rows.start if rows is not None else 0, **kw)
        out[noise] = got.numpy()
        out[noise + "_err"] = max_err(got, mesh.shard_batch(want))
    np.savez(os.path.join(out_dir, f"{mode}_rank{rank}.npz"), **out)
    save_json(mode, {"traffic": mesh.traffic, **{
        k: v for k, v in out.items() if k.endswith("_err")}})
    print("MH_SPATIAL_G_OK", rank, flush=True)

def spatial_step():
    from shgan_torch.parallel import spatial
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    real, mask, _ = graft_batch()

    def one_step(step_mesh, sharded, grads=None):
        G, D = graft_models()
        step = TrainStep(G, D, TrainConfig(), mesh=step_mesh)
        if grads is not None:
            recording(step.opt_g, "G", grads)
            recording(step.opt_d, "D", grads)
        r, m = ((step_mesh.shard_batch(real), step_mesh.shard_batch(mask))
                if step_mesh is not None else (real, mask))
        if sharded:
            with spatial.spatial_sharding(mesh, min_res=16):
                metrics = step(r, m, step_generator(0, 0), 0.99,
                               do_greg=True, do_dreg=True)
        else:
            metrics = step(r, m, step_generator(0, 0), 0.99, do_greg=True,
                           do_dreg=True)
        return step, {k: float(v) for k, v in metrics.items()}

    g_ref, g_got = {}, {}
    ref, ref_m = one_step(None, False, g_ref)
    got, got_m = one_step(mesh, True, g_got)
    check_replicated([got.G, got.D, got.G_ema, got.pl_mean], mesh=mesh)

    def params(step):
        return {("G." + k): v for k, v in step.G.state_dict().items()} | {
            ("D." + k): v for k, v in step.D.state_dict().items()}
    pa, pb = params(got), params(ref)
    # each gradient leaf as the optimizer reads it, relative to its norm:
    # a leaf at the wrong scale moves Adam's first update by nothing
    leaf = {k: float(np.linalg.norm((g_got[k] - g).astype(np.float64))
                     / max(np.linalg.norm(g.astype(np.float64)), 1e-30))
            for k, g in g_ref.items()}
    rec = {"loss_err": {k: abs(got_m[k] - ref_m[k]) for k in ref_m},
           "param_err": max(max_err(pa[k], pb[k]) for k in pb),
           "grad_leaf_rel": max(leaf.values()),
           "grad_leaf_worst": max(leaf, key=leaf.get),
           "grad_leaves": len(leaf), "metrics": got_m,
           "replica_gap": mesh.replica_gap}
    if MODEL > 1:
        # a gradient that one model rank holds apart from the other (a
        # replicated tensor that missed the gradient rule) is refused
        p = torch.nn.Parameter(torch.zeros(3))
        p.grad = torch.full((3,), 1.0 + mesh.model_index)
        try:
            mesh.average_grads([p])
            rec["apart_refused"] = False
        except ValueError:
            rec["apart_refused"] = True
    if MODEL == 1:
        # a model-1 mesh: the context is a no-op, the step today's bit for
        # bit (against the same mesh's step outside the context)
        plain, plain_m = one_step(mesh, False)
        pc = params(plain)
        rec["model1_bit_equal"] = all(torch.equal(pa[k], pc[k]) for k in pc)
        rec["model1_metrics_equal"] = got_m == plain_m
    save_json("spatial_step", rec)
    print("MH_SPATIAL_STEP_OK", rank, flush=True)


def spatial_remat():
    from shgan_torch.parallel import spatial
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    real, mask, z = graft_batch()
    r, m = mesh.shard_batch(real), mesh.shard_batch(mask)
    out = {}
    for name, remat in (("plain", False), ("remat", True)):
        G, D = graft_models()
        for mod in (G.encoder, G.synthesis, D):
            mod.remat = remat
        step = TrainStep(G, D, TrainConfig(), mesh=mesh)
        grads = {}
        recording(step.opt_g, "G", grads)
        recording(step.opt_d, "D", grads)
        mesh.traffic.update(halo_bytes=0, sum_bytes=0)
        with spatial.spatial_sharding(mesh, min_res=16):
            metrics = step(r, m, step_generator(0, 0), 0.99, do_greg=True,
                           do_dreg=True)
        check_replicated([step.G, step.D, step.G_ema, step.pl_mean],
                         mesh=mesh)
        out[f"halo_bytes_{name}"] = np.int64(mesh.traffic["halo_bytes"])
        # G's forward on the slabs, its backward outside the sharding: the
        # recompute must run on the slabs it ran on
        G2, _ = graft_models(seed=1)
        for mod in (G2.encoder, G2.synthesis):
            mod.remat = remat
        x = torch.cat([mask - 0.5, real * mask], dim=1)
        with spatial.spatial_sharding(mesh, min_res=16):
            img = G2(mesh.shard_batch(x), mesh.shard_batch(z),
                     noise_mode="random", noise_seed=5)
        (img.square().mean() + img.mean()).backward()
        arrays = dict(grads, pl_mean=step.pl_mean.numpy(),
                      **{f"M_{k}": v.detach().numpy()
                         for k, v in metrics.items()},
                      **{f"W_{k}": v.detach().numpy()
                         for k, v in step.G.state_dict().items()},
                      **{f"B_{k}": p.grad.numpy()
                         for k, p in G2.named_parameters()
                         if p.grad is not None})
        out.update({f"{name}_{k}": v for k, v in arrays.items()})
    np.savez(os.path.join(out_dir, f"spatial_remat_rank{rank}.npz"), **out)
    print("MH_SPATIAL_REMAT_OK", rank, flush=True)


if mode.startswith("spatial"):
    # a comma-separated list of spatial modes, one process group for all
    for m in mode.split(","):
        {"spatial_ops": spatial_ops, "spatial_step": spatial_step,
         "spatial_remat": spatial_remat}.get(m, lambda m=m: spatial_g(m))()
    if world > 1:
        # every rank's point-to-point work done before the group goes away
        import torch.distributed as dist
        barrier()
        dist.destroy_process_group()
