"""The eval and train stages on one device (port of ``eval_stage``,
``train_stage`` and their helpers in ``shgan_tpu/runtime/stages.py``).

Eval: ``python -m shgan_torch.main`` → :class:`eval_stage` → the host
pipeline (:mod:`..data.pipeline`) → ``models/infer.composite_forward`` →
the evaluators (Inception → FID, KID, PR, IS; LPIPS, PSNR, SSIM) → after
the stream, the metrics that drive the generator themselves (PPL) →
``result.json``.  A loadgen dataset (``--evalnog_path``) scores
pre-generated images instead, with no generator (:meth:`eval_stage.
_eval_pregen`).

Train: ``python -m shgan_torch.main`` → :class:`train_stage` →
``TrainPipeline`` → :class:`~..train.TrainStep` (Gmain [+ Gpl], Dmain
[+ R1], the optimizers with their LR schedules, G-EMA) → snapshots
(:mod:`..checkpoint.train_state`), with G_ema's image grids, the nested
eval and its ``-best`` snapshot (:func:`make_nested_eval`) and a profiler
trace of three steps.  ``train.remat: true`` builds G and D with their
blocks checkpointed (:func:`remat_configs`, ``models/remat.py``).

Both stages run on one device or on each rank of a process group
(:mod:`..parallel`: one process per device, started by ``python -m
shgan_torch.main --gpu 0 1``, torchrun or the ``SHGAN_DIST_*`` variables).
Across ranks the global batch is ``batch_size_per_gpu`` times the ranks;
eval: each rank runs its contiguous shard of the dataset, z and the random
noise keyed by each row's dataset position (so the images do not depend on
the layout), the evaluators gather their rows before ``compute`` and the
lead writes ``result.json``; train: each rank takes its rows of every
global batch, the step averages the gradients, the lead writes the log,
the grids and the snapshots, and every rank loads a resumed snapshot and
checks its replica.  In one process ``env.mesh_devices > 1`` runs the
global batch of that many devices on one.  The device image bank is a TPU
formulation: the flag is accepted and the host pipeline runs.
"""

from __future__ import annotations

import copy
import os
import os.path as osp
import timeit

import numpy as np
import torch

from ..checkpoint.convert import load_pth, params_from_jax
from ..checkpoint.snapshot import (load_network_snapshot,
                                   tf_params_to_torch_state_dict)
from ..checkpoint.train_state import load_train_state, save_train_state
from ..data.datasets import get_dataset
from ..data.formatters import get_formatter
from ..data.pipeline import (EvalPipeline, TrainPipeline, _Prefetcher,
                             _to_device)
from ..data.rng import derive_seed
from ..data.sampler import shard_indices
from ..data.transforms import wrap_formatter
from ..eval import get_evaluator
from ..models.infer import composite, composite_forward, z_for_positions
from ..models.registry import get_model
from ..parallel import Mesh, check_replicated, create_mesh
from .compiled import CompiledForward, eager_reason
from ..parallel.multihost import (barrier, is_lead, local_device,
                                  world_size)
from ..serve import BATCH_NOISE_SALT, resolve_device
from ..train import TrainConfig, TrainStep, compute_ema_beta
from ..train.loss import noise_seed as draw_noise_seed
from .logging import ScalarLogger, print_log

TRAIN_SALT = 0x7A11  # epoch slot of derive_seed for a train step's draws
NESTED_EVAL_METRICS = ("psnr", "ssim", "fid")
PROFILE_AT = 8     # the profiler records steps PROFILE_AT .. PROFILE_AT + 2


def build_generator(cfg_model, pretrained_pth=None, strict=True, seed=0,
                    snapshot_key="G_ema"):
    """The generator of ``cfg_model`` with weights drawn from ``seed``,
    optionally overwritten from a released ``.pth`` state_dict (all of them
    with ``strict``, else those whose names the model has), or from the
    ``snapshot_key`` network of a reference training snapshot ``.pkl``
    (always a non-strict merge, as the reference's
    ``copy_params_and_buffers(require_all=False)``; a legacy TF pickle's
    variables go through the TF → torch remap first)."""
    G = get_model(cfg_model, seed=seed)
    if pretrained_pth is None:
        return G
    if not osp.isfile(pretrained_pth):
        raise FileNotFoundError(pretrained_pth)
    if pretrained_pth.endswith(".pkl"):
        data, is_tf = load_network_snapshot(pretrained_pth)
        sd = data.get(snapshot_key)
        if sd is None:
            raise KeyError(f"{pretrained_pth} holds no {snapshot_key}")
        if is_tf:
            sd, unmatched = tf_params_to_torch_state_dict(sd)
            if unmatched:
                print_log(f"TF pickle: {len(unmatched)} unmatched "
                          f"variables (first: {unmatched[:4]})")
        _load_weights(G, params_from_jax(sd), strict=False)
    else:
        _load_weights(G, load_pth(pretrained_pth), strict)
    print_log(f"Load from [{pretrained_pth}] strict_sd [{strict}]")
    return G


def _load_weights(G, sd, strict):
    """All of ``sd`` into ``G`` (``strict``), or the entries whose names
    ``G`` has; shapes must match either way."""
    if strict:
        G.load_state_dict(sd, strict=True)
        return
    own = G.state_dict()
    for k, v in sd.items():
        if k in own and tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint {k}: shape {tuple(v.shape)}, "
                             f"model {tuple(own[k].shape)}")
    G.load_state_dict({k: v for k, v in sd.items() if k in own},
                      strict=False)


def save_image_grid(images, path, drange=(-1, 1), grid_size=(8, 6)):
    """Tile NCHW images (numpy) into one PNG."""
    from PIL import Image
    lo, hi = drange
    imgs = np.asarray(images, np.float32)
    imgs = (imgs - lo) / (hi - lo) * 255
    imgs = np.rint(imgs).clip(0, 255).astype(np.uint8)
    gw, gh = grid_size
    n, c, h, w = imgs.shape
    grid = np.zeros((c, gh * h, gw * w), np.uint8)
    for i in range(min(n, gw * gh)):
        y, x = divmod(i, gw)
        grid[:, y * h:(y + 1) * h, x * w:(x + 1) * w] = imgs[i]
    grid = grid.transpose(1, 2, 0)
    if c == 1:
        grid = grid[:, :, 0]
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    Image.fromarray(grid).save(path)


def draw_demo_grid(G, dataset, formatter, log_dir, device, grid_size=(8, 6),
                   batch=16, seed=0, subfolder="demo", filename="fakes.png"):
    """Demo grids: fakes / fakes_combined / masks / reals / erased."""
    n = grid_size[0] * grid_size[1]
    rng = np.random.RandomState(seed)
    reals, masks = [], []
    for i in range(n):
        r, m, _ = formatter(dataset[i % len(dataset)])
        r = np.asarray(r)
        if r.dtype == np.uint8:
            r = r.astype(np.float32) / 127.5 - 1.0
        reals.append(np.asarray(r, np.float32))
        masks.append(np.asarray(m, np.float32))
    real = np.stack(reals)
    mask = np.stack(masks)[:, None]
    erased = real * mask
    x = np.concatenate([mask - 0.5, erased], axis=1)
    z = rng.randn(n, G.z_dim).astype(np.float32)
    fakes = []
    with torch.inference_mode():
        for i in range(0, n, batch):
            fakes.append(G(torch.from_numpy(x[i:i + batch]).to(device),
                           torch.from_numpy(z[i:i + batch]).to(device),
                           noise_mode="const").float().cpu().numpy())
    fake = np.concatenate(fakes)
    out = osp.join(log_dir, subfolder)
    save_image_grid(fake, osp.join(out, filename), (-1, 1), grid_size)
    combined = real * mask + fake * (1 - mask)
    stem, ext = osp.splitext(filename)
    save_image_grid(combined, osp.join(out, stem + "_combined" + ext),
                    (-1, 1), grid_size)
    save_image_grid(mask, osp.join(out, "masks.png"), (0, 1), grid_size)
    save_image_grid(real, osp.join(out, "reals.png"), (-1, 1), grid_size)
    save_image_grid(erased, osp.join(out, "erased.png"), (-1, 1), grid_size)


def _num_workers(cfg_section):
    """Host pipeline worker threads: ``dataset_num_workers``, else
    ``dataset_num_workers_per_gpu`` (one device), else None (auto)."""
    w = cfg_section.get("dataset_num_workers")
    if w is None:
        w = cfg_section.get("dataset_num_workers_per_gpu")
    return w


def run_mesh(cfge, device=None):
    """The run's mesh: every rank of the process group, each on its
    device (``device``, else the one its rank was given, else
    ``env.device``, else its CUDA device), or this process alone on
    ``device``, else ``env.device``, else the CUDA device (raises without
    one; ``"cpu"`` runs the kernels' plain versions)."""
    if device is None:
        device = cfge.get("device")
    if world_size() > 1:
        return create_mesh(cfge.get("mesh_devices"),
                           device=device if device is not None
                           else local_device(),
                           backend=cfge.get("dist_backend"))
    return Mesh(device=resolve_device(device))


def global_batch(cfg_section, cfge, mesh):
    """The global batch: ``batch_size``, else ``batch_size_per_gpu`` times
    the devices (the ranks, or ``env.mesh_devices`` in one process)."""
    n_dev = mesh.world if mesh.world > 1 else (cfge.get("mesh_devices") or 1)
    return cfg_section.get("batch_size") or (
        cfg_section["batch_size_per_gpu"] * n_dev)


def _views(fake_u8, real):
    """(host views, device views) of one batch, the JAX package's formulas:
    detector inputs 0..255 (``fake``/``real``) and [0, 1] pairs
    (``pred``/``gt``).  uint8 transport passes the uint8 tensors as the
    device views.  The host views are built lazily."""
    if real.dtype == torch.uint8:
        dev = {"fake_dev": fake_u8, "real_dev": real,
               "pred_dev": fake_u8, "gt_dev": real}
    else:
        f32 = fake_u8.float()
        dev = {"fake_dev": f32, "real_dev": real * 127.5 + 127.5,
               "pred_dev": f32 / 255.0, "gt_dev": (real + 1) / 2}

    def host():
        fake_np = fake_u8.cpu().numpy().astype(np.float32)
        real_np = real.cpu().numpy()
        if real_np.dtype == np.uint8:
            real255 = real_np.astype(np.float32)
            gt = real255 / 255.0
        else:
            real255 = real_np * 127.5 + 127.5
            gt = (real_np + 1) / 2
        return dict(pred=fake_np / 255.0, gt=gt, fake=fake_np, real=real255)
    return host, dev


class eval_stage:
    """Evaluation of a (pretrained) generator on one device or over the
    ranks of a process group."""

    def __call__(self, cfg, device=None):
        """Run the eval section of ``cfg``.  ``device``: as in
        :func:`run_mesh`.  Returns ``{"eval_rv": {metric: value},
        "timing": {...}}`` on every rank."""
        cfgv = cfg["eval"]
        cfge = cfg.get("env") or {}
        seed = cfge.get("rnd_seed", 0) or 0
        log_dir = cfgv.get("log_dir") or "log/eval"
        mesh = run_mesh(cfge, device)
        dev = mesh.device
        batch_size = global_batch(cfgv, cfge, mesh)
        lo, hi = mesh.split(batch_size)
        local_bs = hi - lo
        print_log(f"device: {dev}, eval batch: {batch_size}"
                  + (f" ({local_bs} on each of {mesh.world} ranks, "
                     f"{mesh.backend})" if mesh.world > 1 else ""))

        ds_cfg = cfgv["dataset"]
        if cfgv.get("device_image_bank", False):
            print_log("device_image_bank: a TPU formulation; the host "
                      "pipeline runs")

        dataset = get_dataset(ds_cfg, fallback_synthetic=cfge.get("debug",
                                                                  False))
        if (str(ds_cfg.get("type", "")).endswith("loadgen")
                or ds_cfg.get("gen_dir")
                or (ds_cfg.get("args") or {}).get("gen_dir")):
            # pre-generated images (--evalnog_path): no generator
            evaluator = self._build_evaluator(cfgv, cfge)
            rv = self._eval_pregen(dataset, evaluator, local_bs, log_dir,
                                   dev, log_display=cfgv.get("log_display",
                                                             10),
                                   num_threads=_num_workers(cfgv), mesh=mesh)
            return {"eval_rv": rv}
        formatter = wrap_formatter(get_formatter(ds_cfg["formatter"]),
                                   ds_cfg.get("transforms"))
        pipe = EvalPipeline(dataset, formatter, local_bs, device=dev,
                            seed=seed, num_threads=_num_workers(cfgv),
                            transport=cfgv.get("transport", "f32"),
                            shard_id=mesh.rank, num_shards=mesh.world)

        pretrained = cfgv.get("pretrained_pth")
        if (pretrained and not osp.isfile(pretrained)
                and cfge.get("debug", False)):
            print_log(f"debug: pretrained [{pretrained}] missing — "
                      "using random init")
            pretrained = None
        G = build_generator(cfg["model_g"], pretrained,
                            strict=cfgv.get("strict_sd", True), seed=seed)
        G = G.to(dev).eval().requires_grad_(False)

        if cfgv.get("output_sample_images", False):
            if is_lead():
                draw_demo_grid(G, dataset, formatter, log_dir, dev)
            if cfgv.get("demo_only", False):
                print_log(f"demo grid written to {log_dir}/demo")
                return {"eval_rv": None}

        evaluator = self._build_evaluator(cfgv, cfge)
        noise_mode = cfgv.get("noise_mode", "random")
        needs_np = evaluator.consumes_host_pixels
        needs_dev = evaluator.consumes_device_views
        log_display = cfgv.get("log_display", 10)

        batch_s = []
        # z and the random noise of dataset position i: the same for any
        # batch layout and rank count (the noise's counter row is i)
        noise_seed = derive_seed(seed, 0, BATCH_NOISE_SALT)
        rows = mesh.rows(batch_size)
        # one rank on CUDA: the forward replays one captured graph a batch
        # (row0 = the batch's start goes into the noise table); several
        # ranks run it eagerly, since the style statistic's all_reduce
        # runs through gloo on the host, which a graph cannot capture
        why = eager_reason(G, [dev], mesh.world)
        compiled = CompiledForward(G, noise_mode) if why is None else None
        if dev.type == "cuda":
            print_log("generator forward: " + (
                "one CUDA graph a batch shape" if why is None
                else f"eager ({why})"))
        try:
            t0 = t_prev = timeit.default_timer()
            for idx, (real, mask, valid, uids) in enumerate(pipe):
                start = pipe.shard.global_offset + idx * local_bs
                z = torch.from_numpy(z_for_positions(
                    seed, G.z_dim, range(start, start + local_bs)))
                if compiled is not None:
                    fake = compiled(real, mask, z, noise_seed, row0=start)
                else:
                    with torch.inference_mode():
                        fake = composite_forward(
                            G, real, mask, z.to(dev), noise_mode=noise_mode,
                            noise_seed=noise_seed, row0=start, rows=rows)
                host, dev_views = _views(fake, real)
                pixels = (host() if needs_np else
                          dict(pred=None, gt=None, fake=None, real=None))
                # the masks feed only the metrics that drive the generator
                # (PPL's contexts)
                evaluator.add_batch(
                    mask=mask if evaluator.needs_generator else None,
                    fn=uids, valid=valid, **pixels,
                    **(dev_views if needs_dev else {}))
                now = timeit.default_timer()
                batch_s.append(now - t_prev)
                t_prev = now
                if idx % log_display == log_display - 1:
                    print_log("processed.. {}, Time:{:.2f}s".format(
                        idx + 1, now - t0))
                    t0 = now

            t_loop_end = timeit.default_timer()
            evaluator.drain()
            drain_s = timeit.default_timer() - t_loop_end
            if mesh.world > 1:
                # every rank's rows, in the dataset's order
                evaluator.sync_across_processes()
            gen_metrics_s = 0.0
            if evaluator.needs_generator:
                # the metrics that drive the generator run after the stream
                t_g = timeit.default_timer()
                evaluator.run_generator_metrics(G, seed=seed)
                evaluator.drain()
                gen_metrics_s = timeit.default_timer() - t_g
        finally:
            if compiled is not None:
                compiled.release()

        evaluator.set_sample_n(len(dataset))
        rv = evaluator.compute()
        if is_lead():
            evaluator.one_line_summary()
            evaluator.save(log_dir)
        evaluator.clear_data()
        # per-batch wall times; batch 0 carries the first-use set-up
        timing = {"batch_s": batch_s, "drain_s": drain_s,
                  "generator_metrics_s": gen_metrics_s,
                  "global_batch": batch_size, "images": len(dataset),
                  "ranks": mesh.world}
        return {"eval_rv": rv, "timing": timing}

    @staticmethod
    def _build_evaluator(cfgv, cfge):
        try:
            return get_evaluator(cfgv["evaluator"])
        except FileNotFoundError as e:
            if not cfge.get("debug", False):
                raise
            # debug runs without detector weights keep the weight-free
            # metrics
            print_log(f"debug: evaluator asset missing ({e}); "
                      "falling back to [psnr, ssim]")
            return get_evaluator([{"type": "psnr"}, {"type": "ssim"}])

    @staticmethod
    def _eval_pregen(dataset, evaluator, batch_size, log_dir, device,
                     log_display=10, num_threads=None, mesh=None):
        """The metrics over (real, pre-generated) pairs of a loadgen
        dataset, with no generator: batches decode on the prefetch pool
        (two PNG decodes an element) and go to ``device`` in the worker;
        the evaluators read them there as the device views.  Across ranks
        each takes its contiguous shard (padded to equal lengths, the pads
        not valid) in batches of ``batch_size`` and the rows are gathered
        before ``compute``."""
        t0 = timeit.default_timer()
        n = len(dataset)
        world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
        order, ok = shard_indices(n, rank, world)
        needs_np = evaluator.consumes_host_pixels
        needs_dev = evaluator.consumes_device_views

        def make_batch(b):
            at = slice(b * batch_size, (b + 1) * batch_size)
            els = [dataset[int(i)] for i in order[at]]
            real = np.stack([e["image"] for e in els])       # [N,3,H,W] 0-1
            gen = np.stack([e["gen"] for e in els])
            dev = (_to_device(real, device), _to_device(gen, device))
            return real, gen, dev, [e["unique_id"] for e in els], ok[at]

        pf = _Prefetcher(make_batch, -(-len(order) // batch_size),
                         num_threads=num_threads)
        for idx, (real, gen, (real_t, gen_t), uids, valid) in enumerate(pf):
            host = (dict(pred=gen, gt=real, fake=gen * 255.0,
                         real=real * 255.0) if needs_np else
                    dict(pred=None, gt=None, fake=None, real=None))
            dev = (dict(pred_dev=gen_t, gt_dev=real_t,
                        fake_dev=gen_t * 255.0, real_dev=real_t * 255.0)
                   if needs_dev else {})
            evaluator.add_batch(fn=uids, valid=valid, **host, **dev)
            if idx % log_display == log_display - 1:
                print_log("processed.. {}, Time:{:.2f}s".format(
                    idx + 1, timeit.default_timer() - t0))
                t0 = timeit.default_timer()
        evaluator.drain()
        if world > 1:
            evaluator.sync_across_processes()
        evaluator.set_sample_n(n)
        rv = evaluator.compute()
        if is_lead():
            evaluator.one_line_summary()
            evaluator.save(log_dir)
        evaluator.clear_data()
        return rv


def step_generator(seed, step):
    """The CPU ``torch.Generator`` of train step ``step``'s random draws
    (z, style mixing, dropout, noise seeds, path-length noise): a function
    of (seed, step) alone, so a resumed run draws what the uninterrupted
    run would have, on any device."""
    return torch.Generator().manual_seed(derive_seed(seed, step, TRAIN_SALT))


def snapshot_name(cur_nimg):
    return "network-snapshot-{:06d}".format(cur_nimg // 1000)


def next_eval_nimg(cur_nimg, eval_every_kimg):
    """The first multiple of the eval interval strictly above ``cur_nimg``:
    at the start, after a resume, and after each nested eval (a tick that
    crosses several intervals runs one eval)."""
    step_n = eval_every_kimg * 1000
    return (cur_nimg // step_n + 1) * step_n


def is_improvement(value, best, higher_better):
    """A strict improvement of ``value`` over ``best`` in the metric's
    direction (any value improves on ``None``)."""
    return best is None or (value != best and (value > best)
                            == higher_better)


def nested_eval_views(fake, real, host=False):
    """The evaluator views of one nested eval batch, the JAX package's
    formulas: ``pred = fake / 255``, ``gt = (real + 1) / 2``, ``fake``,
    ``real * 127.5 + 127.5``, as device views, and as numpy host views
    with ``host``."""
    dev = {"pred_dev": fake / 255.0, "gt_dev": (real + 1) / 2,
           "fake_dev": fake, "real_dev": real * 127.5 + 127.5}
    views = dict(dev)
    for k, v in dev.items():
        views[k[:-4]] = v.cpu().numpy() if host else None
    return views


def make_nested_eval(cfg, G, device, mesh=None):
    """G_ema → ``(metric, value, higher_better)`` over the first
    ``eval.nested_eval_samples`` (default 64) images of the eval dataset
    (JAX ``train_stage._make_nested_eval``).  ``nested_eval_metric`` is
    ``psnr`` (the default), ``ssim`` or ``fid``; ``fid`` takes the eval
    section's fid args with a run-local real-feature cache
    (``<log_dir>/.cache``, tag ``nested<samples>``: the subset is fixed, so
    the first eval writes the real features and the later ones read them),
    and falls back to ``psnr`` when the detector weights are missing.  The
    scored images are quantized with ``rint`` for fid.

    Each eval draws z (at the global batch's shape) and the noise seeds
    from a CPU ``torch.Generator`` seeded with ``env.rnd_seed + 12345``, and
    nothing from the train steps' generators; the JAX package draws them
    from ``jax.random`` with the same seed, so the two packages' draws
    differ by design.  Across the ranks of ``mesh`` each evaluates its
    contiguous shard and the evaluators gather the rows."""
    cfgv = copy.deepcopy(cfg["eval"])
    cfge = cfg.get("env") or {}
    mesh = mesh or Mesh(device=device)
    samples = cfgv.get("nested_eval_samples", 64)
    if cfgv.get("dataset") is not None:
        cfgv["dataset"]["try_sample"] = samples
    dataset = get_dataset(cfgv["dataset"],
                          fallback_synthetic=cfge.get("debug", False))
    formatter = wrap_formatter(get_formatter(cfgv["dataset"]["formatter"]),
                               cfgv["dataset"].get("transforms"))
    if not cfgv.get("batch_size") and "batch_size_per_gpu" not in cfgv:
        cfgv["batch_size_per_gpu"] = 4
    batch_size = global_batch(cfgv, cfge, mesh)
    rows = mesh.rows(batch_size)
    lo, hi = mesh.split(batch_size)
    pipe = EvalPipeline(dataset, formatter, hi - lo, device=device,
                        num_threads=_num_workers(cfgv), shard_id=mesh.rank,
                        num_shards=mesh.world)
    metric = cfgv.get("nested_eval_metric", "psnr")
    # scalar metrics only: is / pr return dicts and PPL drives the
    # generator itself; fail at build time, not at the first eval tick
    if metric not in NESTED_EVAL_METRICS:
        raise ValueError(
            f"nested_eval_metric [{metric}] unsupported — the in-train"
            f" nested eval runs scalar metrics only "
            f"{NESTED_EVAL_METRICS}; run the full evaluator compose via the"
            " eval stage instead")
    fid_args = None
    if metric == "fid":
        fid_args = {}
        for e in cfgv.get("evaluator") or []:
            if isinstance(e, dict) and e.get("type") == "fid":
                fid_args = dict(e.get("args") or {})
        fid_args.update(
            sample_real_n=None, sample_fake_n=None,
            dsstat_cachefile_tag=f"nested{samples}",
            cache_dir=osp.join(cfg["train"].get("log_dir") or "log/train",
                               ".cache"))
        try:
            get_evaluator([{"type": "fid", "args": fid_args}])
        except FileNotFoundError as e:
            print_log(f"nested eval: fid detector unavailable ({e}) — "
                      "falling back to psnr")
            metric, fid_args = "psnr", None
    higher_better = metric != "fid"   # psnr and ssim up, fid down
    seed = (cfge.get("rnd_seed", 0) or 0) + 12345

    def run(G_ema):
        evaluator = get_evaluator(
            [{"type": "fid", "args": fid_args}] if fid_args is not None
            else [{"type": metric}])
        gen = torch.Generator().manual_seed(seed)
        with torch.inference_mode():
            for real, mask, valid, uids in pipe:
                z = torch.randn(batch_size, G.z_dim, generator=gen)[lo:hi]
                fake = composite(G_ema, real, mask, z.to(device), "random",
                                 draw_noise_seed(gen), row0=lo, rows=rows)
                if fid_args is not None:
                    fake = torch.round(fake)   # the protocol's uint8 values
                evaluator.add_batch(fn=uids, valid=valid, **nested_eval_views(
                    fake, real, evaluator.consumes_host_pixels))
        evaluator.drain()
        if mesh.world > 1:
            evaluator.sync_across_processes()
        evaluator.set_sample_n(len(dataset))
        rv = evaluator.compute()
        evaluator.clear_data()
        return metric, float(rv[metric]), higher_better

    return run


class _StepProfiler:
    """``torch.profiler`` over the steps ``PROFILE_AT`` to ``PROFILE_AT +
    2`` of a run (counted from its first step), CPU and, on a CUDA
    device, CUDA activity, without shapes or stacks; one Chrome trace is
    written into ``profile_dir``."""

    def __init__(self, profile_dir, device):
        self.dir, self.device = profile_dir, device
        self.prof, self.first = None, None

    def before(self, count, step_i):
        if count != PROFILE_AT:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False)
        self.prof.__enter__()
        self.first = step_i

    def after(self, count, step_i):
        if self.prof is None or count != PROFILE_AT + 2:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        path = osp.join(self.dir,
                        f"train_steps{self.first:06d}-{step_i:06d}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        print_log(f"wrote profiler trace to {path}")

    def close(self):
        """Stop a trace that a run too short to reach its end left open."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None


def remat_configs(cfg_g, cfg_d):
    """Copies of the G and D model configs with ``remat`` on in G's
    ``encoder`` and ``synthesis`` and in D, where the JAX package sets it
    (``shgan_tpu/runtime/stages.py:565-575``); the configs given are left
    as they are."""
    cfg_g, cfg_d = copy.deepcopy(cfg_g), copy.deepcopy(cfg_d)
    for sub in ("encoder", "synthesis"):
        sub_cfg = (cfg_g.get("args") or {}).get(sub)
        if isinstance(sub_cfg, dict):
            sub_cfg.setdefault("args", {})["remat"] = True
    cfg_d.setdefault("args", {})["remat"] = True
    return cfg_g, cfg_d


class train_stage:
    """The StyleGAN2/CoModGAN training loop on one device or over the
    ranks of a process group."""

    def __call__(self, cfg, device=None, on_step=None, on_step_start=None):
        """Run the train section of ``cfg``.  ``device`` as in
        :class:`eval_stage`.  ``on_step_start(step_i)`` and ``on_step(step_i,
        metrics)``, if given, are called just before and just after each
        step (``metrics`` on the device); the snapshots, image grids and
        nested evals fall between them.  ``train.eval_every_kimg`` runs
        :func:`make_nested_eval` at the first tick past each interval; its
        ``eval_<metric>`` joins that tick's record, and each strict
        improvement writes
        ``weight/network-snapshot-best``.  ``train.profile_dir`` (or
        ``SHGAN_PROFILE_DIR``) traces three steps there.  Returns ``{"step":
        the TrainStep, "ticks": [per-tick metric means, with "kimg" and
        "tick"], "timing": {...}}``; ``stats.jsonl`` holds a
        ``ScalarLogger`` record a tick.  Across ranks (``device`` as in
        :func:`run_mesh`) the tick's means are the ranks' means, and the
        lead alone writes the log, the grids, the trace and the snapshots
        (the ranks meet after each snapshot)."""
        cfgt = cfg["train"]
        cfge = cfg.get("env") or {}
        seed = cfge.get("rnd_seed", 0) or 0
        log_dir = cfgt.get("log_dir") or "log/train"
        mesh = run_mesh(cfge, device)
        dev = mesh.device
        batch_size = global_batch(cfgt, cfge, mesh)
        n_dev = cfge.get("mesh_devices") or 1
        print_log(f"device: {dev}, train batch: {batch_size}" + (
            f" ({batch_size // mesh.world} on each of {mesh.world} ranks, "
            f"{mesh.backend})" if mesh.world > 1 else
            f" (the global batch of {n_dev} devices on one)"
            if n_dev > 1 else ""))

        dataset = get_dataset(cfgt["dataset"],
                              fallback_synthetic=cfge.get("debug", False))
        formatter = wrap_formatter(get_formatter(cfgt["dataset"]["formatter"]),
                                   cfgt["dataset"].get("transforms"))
        cfg_g, cfg_d = cfg["model_g"], cfg["model_d"]
        if cfgt.get("remat", False):
            cfg_g, cfg_d = remat_configs(cfg_g, cfg_d)
            print_log("remat: G's encoder and synthesis blocks and D's "
                      "blocks are recomputed in the backward")
        G = get_model(cfg_g, seed=seed).to(dev)
        D = get_model(cfg_d, seed=derive_seed(seed, 1)).to(dev)
        tc = TrainConfig(**(cfgt.get("loss_kwargs") or {}))
        step = TrainStep(G, D, tc, mesh=mesh)

        total_nimg = cfgt.get("total_kimg", 25000) * 1000
        kimg_per_tick = cfgt.get("kimg_per_tick", 4)
        snapshot_ticks = cfgt.get("snapshot_ticks", 50)
        # G_ema's image grids (fakes_init.png, then fakes<kimg>.png every
        # image_ticks ticks and at the end); 0/None: none
        image_ticks = cfgt.get("image_snapshot_ticks", snapshot_ticks)
        cur_nimg, cur_tick = 0, 0
        resume_path = cfgt.get("resume_path")
        if resume_path:
            load_train_state(resume_path, step)
            # every rank loaded the snapshot: the replicas must agree
            check_replicated([step.G, step.D, step.G_ema, step.pl_mean],
                             mesh=mesh)
            # resume_itern is in kimg (it names the snapshot picked);
            # without it, progress comes from the restored step counter
            if cfgt.get("resume_itern") is not None:
                cur_nimg = int(cfgt["resume_itern"]) * 1000
            else:
                cur_nimg = step.step * batch_size
            print_log(f"resumed from {resume_path} at step {step.step}, "
                      f"{cur_nimg / 1e3:.3f} kimg")
        tick_start = cur_nimg

        profile_dir = (cfgt.get("profile_dir")
                       or os.environ.get("SHGAN_PROFILE_DIR"))
        profiler = (_StepProfiler(profile_dir, dev)
                    if profile_dir and is_lead() else None)
        eval_every = cfgt.get("eval_every_kimg")
        nested_eval = None
        if eval_every and cfg.get("eval"):
            nested_eval = make_nested_eval(cfg, G, dev, mesh)
        # best_metric starts anew after a resume, as in the JAX package
        best_metric, next_eval = None, None
        if eval_every:
            next_eval = next_eval_nimg(cur_nimg, eval_every)

        pipe = TrainPipeline(
            dataset, formatter, batch_size, device=dev, seed=seed,
            num_threads=_num_workers(cfgt), start=cur_nimg // batch_size,
            rows=(mesh.batch_rows(batch_size, tc.grad_accum)
                  if mesh.world > 1 else None))
        timing = {"step_s": [], "global_batch": batch_size,
                  "nested_eval_s": []}
        ticks, pending = [], []
        logger = ScalarLogger(log_dir if is_lead() else None,
                              tensorboard=cfgt.get("log_tensorboard", False))

        def grid(filename):
            if is_lead():
                draw_demo_grid(step.G_ema, dataset, formatter, log_dir, dev,
                               subfolder="demo", filename=filename)

        if image_ticks:
            grid("fakes_init.png")
        try:
            t_tick = t_prev = timeit.default_timer()
            it = iter(pipe)
            count = 0
            while cur_nimg < total_nimg:
                real, mask = next(it)
                step_i = cur_nimg // batch_size
                if profiler is not None:
                    profiler.before(count, step_i)
                if on_step_start is not None:
                    on_step_start(step_i)
                metrics = step(real, mask, step_generator(seed, step_i),
                               compute_ema_beta(tc, batch_size, cur_nimg),
                               do_greg=step_i % tc.g_reg_interval == 0,
                               do_dreg=step_i % tc.d_reg_interval == 0)
                if on_step is not None:
                    on_step(step_i, metrics)
                if profiler is not None:
                    profiler.after(count, step_i)
                count += 1
                # metrics stay on the device: one readback a tick
                pending.append(metrics)
                cur_nimg += batch_size
                now = timeit.default_timer()
                timing["step_s"].append(now - t_prev)
                t_prev = now
                if (cur_nimg >= tick_start + kimg_per_tick * 1000
                        or cur_nimg >= total_nimg):
                    # one readback for the tick's steps
                    keys = sorted(pending[0])
                    vals = mesh.all_reduce_mean_(torch.stack([
                        torch.stack([m[k].float() for k in keys])
                        for m in pending])).tolist()
                    pending.clear()
                    for v in vals:
                        logger.accumulate(dict(zip(keys, v)))
                    if nested_eval is not None and cur_nimg >= next_eval:
                        next_eval = next_eval_nimg(cur_nimg, eval_every)
                        t_eval = timeit.default_timer()
                        name, value, higher_better = nested_eval(step.G_ema)
                        timing["nested_eval_s"].append(
                            timeit.default_timer() - t_eval)
                        logger.accumulate({f"eval_{name}": value})
                        print_log(f"nested eval @ {cur_nimg / 1e3:.3f} kimg:"
                                  f" {name}={value:.4f}")
                        if is_improvement(value, best_metric, higher_better):
                            best_metric = value
                            self.save_snapshot(step, log_dir, cur_nimg,
                                               tag="best")
                            print_log(f"new best {name}={value:.4f}")
                    means = logger.flush(cur_nimg)
                    dt = timeit.default_timer() - t_tick
                    t_tick = timeit.default_timer()
                    print_log("tick {:<5d} kimg {:<8.3f} sec/kimg {:<7.2f} "
                              "loss_g {:.3f} loss_d {:.3f}".format(
                                  cur_tick, cur_nimg / 1e3,
                                  dt / max(cur_nimg - tick_start, 1) * 1e3,
                                  means["loss_g"], means["loss_d"]))
                    ticks.append(dict(means, kimg=cur_nimg / 1e3,
                                      tick=cur_tick))
                    tick_start = cur_nimg
                    cur_tick += 1
                    if cur_tick % snapshot_ticks == 0:
                        self.save_snapshot(step, log_dir, cur_nimg)
                    if image_ticks and cur_tick % image_ticks == 0:
                        grid("fakes{:06d}.png".format(cur_nimg // 1000))
                    t_prev = timeit.default_timer()   # step_s: the steps alone
        finally:
            logger.close()
            if profiler is not None:
                profiler.close()
        self.save_snapshot(step, log_dir, cur_nimg)
        if image_ticks:
            grid("fakes{:06d}.png".format(cur_nimg // 1000))
        return {"step": step, "ticks": ticks, "timing": timing}

    @staticmethod
    def save_snapshot(step, log_dir, cur_nimg, tag=None):
        """``weight/network-snapshot-<kimg>``, or ``-<tag>``: written by
        the lead (the replicas are equal), then the ranks meet."""
        name = (f"network-snapshot-{tag}" if tag
                else snapshot_name(cur_nimg))
        path = osp.join(log_dir, "weight", name)
        if is_lead():
            save_train_state(path, step)
            print_log(f"saved snapshot {path}")
        barrier()
        return path
