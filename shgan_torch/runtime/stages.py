"""The eval and train stages on one device (port of ``eval_stage``,
``train_stage`` and their helpers in ``shgan_tpu/runtime/stages.py``).

Eval: ``python -m shgan_torch.main`` → :class:`eval_stage` → the host
pipeline (:mod:`..data.pipeline`) → ``models/infer.composite_forward`` →
the evaluators (Inception → FID, PSNR, SSIM) → ``result.json``.

Train: ``python -m shgan_torch.main`` → :class:`train_stage` →
``TrainPipeline`` → :class:`~..train.TrainStep` (Gmain [+ Gpl], Dmain
[+ R1], Adam, G-EMA) → snapshots (:mod:`..checkpoint.train_state`).

Still to port: the pre-generated (loadgen) eval path, the device image bank,
the ``.pkl`` snapshot load, multi-device eval and train, the
generator-in-the-loop metrics, and in training the nested eval and the
profiler hook; each raises where the config asks for it.
"""

from __future__ import annotations

import os
import os.path as osp
import timeit

import numpy as np
import torch

from ..checkpoint.convert import load_pth
from ..checkpoint.train_state import load_train_state, save_train_state
from ..data.datasets import get_dataset
from ..data.formatters import get_formatter
from ..data.pipeline import EvalPipeline, TrainPipeline
from ..data.rng import derive_seed
from ..data.transforms import wrap_formatter
from ..eval import get_evaluator
from ..models.infer import composite_forward, z_for_positions
from ..models.registry import get_model
from ..ops import conv1024
from ..serve import BATCH_NOISE_SALT, resolve_device
from ..train import TrainConfig, TrainStep, compute_ema_beta
from .logging import ScalarLogger, print_log

TRAIN_SALT = 0x7A11  # epoch slot of derive_seed for a train step's draws


def build_generator(cfg_model, pretrained_pth=None, strict=True, seed=0):
    """The generator of ``cfg_model`` with weights drawn from ``seed``,
    optionally overwritten from a released ``.pth`` state_dict: all of them
    (``strict``), or those whose names the model has (non-strict merge)."""
    G = get_model(cfg_model, seed=seed)
    if pretrained_pth is None:
        return G
    if not osp.isfile(pretrained_pth):
        raise FileNotFoundError(pretrained_pth)
    if pretrained_pth.endswith(".pkl"):
        raise NotImplementedError(
            "training-snapshot .pkl loading comes with the training slice; "
            "pass a released .pth state_dict")
    sd = load_pth(pretrained_pth)
    if strict:
        G.load_state_dict(sd, strict=True)
    else:
        own = G.state_dict()
        for k, v in sd.items():
            if k in own and tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"checkpoint {k}: shape {tuple(v.shape)}, "
                                 f"model {tuple(own[k].shape)}")
        G.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=False)
    print_log(f"Load from [{pretrained_pth}] strict_sd [{strict}]")
    return G


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
    """Evaluation of a (pretrained) generator on one device."""

    def __call__(self, cfg, device=None):
        """Run the eval section of ``cfg``.  ``device``: the caller's
        choice, else ``env.device``, else the CUDA device (raises without
        one; ``"cpu"`` runs the kernels' plain versions).  Returns
        ``{"eval_rv": {metric: value}, "timing": {...}}``."""
        cfgv = cfg["eval"]
        cfge = cfg.get("env") or {}
        seed = cfge.get("rnd_seed", 0) or 0
        log_dir = cfgv.get("log_dir") or "log/eval"
        if (cfge.get("mesh_devices") or 1) > 1:
            raise NotImplementedError(
                "multi-device eval comes with the parallel/ slice; set "
                "env.mesh_devices to 1")
        dev = resolve_device(device if device is not None
                             else cfge.get("device"))
        batch_size = cfgv.get("batch_size") or cfgv["batch_size_per_gpu"]
        print_log(f"device: {dev}, eval batch: {batch_size}")

        ds_cfg = cfgv["dataset"]
        if (str(ds_cfg.get("type", "")).endswith("loadgen")
                or ds_cfg.get("gen_dir")
                or (ds_cfg.get("args") or {}).get("gen_dir")):
            raise NotImplementedError(
                "eval of pre-generated images (loadgen, --evalnog_path) "
                "comes with a later slice")
        if cfgv.get("device_image_bank", False):
            raise NotImplementedError(
                "device_image_bank comes with a later slice")

        dataset = get_dataset(ds_cfg, fallback_synthetic=cfge.get("debug",
                                                                  False))
        formatter = wrap_formatter(get_formatter(ds_cfg["formatter"]),
                                   ds_cfg.get("transforms"))
        pipe = EvalPipeline(dataset, formatter, batch_size, device=dev,
                            seed=seed, num_threads=_num_workers(cfgv),
                            transport=cfgv.get("transport", "f32"))

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
            draw_demo_grid(G, dataset, formatter, log_dir, dev)
            if cfgv.get("demo_only", False):
                print_log(f"demo grid written to {log_dir}/demo")
                return {"eval_rv": None}

        evaluator = self._build_evaluator(cfgv, cfge)
        noise_mode = cfgv.get("noise_mode", "random")
        needs_np = evaluator.consumes_host_pixels
        needs_dev = evaluator.consumes_device_views
        log_display = cfgv.get("log_display", 10)

        # kernel K3 for the low-channel 3×3 convs at ≥1024², on the card
        # only, for this stage's forwards
        prev_conv = conv1024.conv1024_impl()
        if dev.type == "cuda" and cfgv.get("pallas_conv1024", False):
            conv1024.set_conv1024_impl("pallas")
        # SHGAN_EVAL_TIMING=1: per-batch pipe-wait / generator / metrics
        # split (the generator is fenced with a synchronize)
        phase_log = os.environ.get("SHGAN_EVAL_TIMING") == "1"
        batch_s, phases = [], []
        try:
            t0 = t_prev = timeit.default_timer()
            for idx, (real, mask, valid, uids) in enumerate(pipe):
                t_b = timeit.default_timer()
                start = idx * batch_size
                z = torch.from_numpy(z_for_positions(
                    seed, G.z_dim, range(start, start + batch_size))).to(dev)
                with torch.inference_mode():
                    fake = composite_forward(
                        G, real, mask, z, noise_mode=noise_mode,
                        noise_seed=derive_seed(seed, start,
                                               BATCH_NOISE_SALT))
                if phase_log and fake.is_cuda:
                    torch.cuda.synchronize(fake.device)
                t_c = timeit.default_timer()
                host, dev_views = _views(fake, real)
                pixels = (host() if needs_np else
                          dict(pred=None, gt=None, fake=None, real=None))
                evaluator.add_batch(fn=uids, valid=valid, **pixels,
                                    **(dev_views if needs_dev else {}))
                now = timeit.default_timer()
                if phase_log:
                    phases.append({"pipe_wait_s": t_b - t_prev,
                                   "gen_s": t_c - t_b,
                                   "metrics_s": now - t_c})
                    print_log(f"batch {idx}: pipe_wait {t_b - t_prev:.3f}s "
                              f"gen {t_c - t_b:.3f}s "
                              f"metrics {now - t_c:.3f}s")
                batch_s.append(now - t_prev)
                t_prev = now
                if idx % log_display == log_display - 1:
                    print_log("processed.. {}, Time:{:.2f}s".format(
                        idx + 1, now - t0))
                    t0 = now
        finally:
            conv1024.set_conv1024_impl(prev_conv)

        t_loop_end = timeit.default_timer()
        evaluator.drain()
        drain_s = timeit.default_timer() - t_loop_end
        evaluator.set_sample_n(len(dataset))
        rv = evaluator.compute()
        evaluator.one_line_summary()
        evaluator.save(log_dir)
        evaluator.clear_data()
        # per-batch wall times; batch 0 carries the first-use set-up
        timing = {"batch_s": batch_s, "drain_s": drain_s,
                  "global_batch": batch_size, "images": len(dataset)}
        if phase_log:
            timing["phase_s"] = phases
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


def step_generator(seed, step):
    """The CPU ``torch.Generator`` of train step ``step``'s random draws
    (z, style mixing, dropout, noise seeds, path-length noise): a function
    of (seed, step) alone, so a resumed run draws what the uninterrupted
    run would have, on any device."""
    return torch.Generator().manual_seed(derive_seed(seed, step, TRAIN_SALT))


def snapshot_name(cur_nimg):
    return "network-snapshot-{:06d}".format(cur_nimg // 1000)


class train_stage:
    """The StyleGAN2/CoModGAN training loop on one device."""

    def __call__(self, cfg, device=None, on_step=None, on_step_start=None):
        """Run the train section of ``cfg``.  ``device`` as in
        :class:`eval_stage`.  ``on_step_start(step_i)`` and ``on_step(step_i,
        metrics)``, if given, are called just before and just after each
        step (``metrics`` on the device); the snapshots and image grids fall
        between them.  ``SHGAN_TRAIN_TIMING=1`` fences each phase of each
        step with a synchronize and returns the per-step split.  Returns
        ``{"step": the TrainStep, "ticks": [per-tick metric means, with
        "kimg" and "tick"], "timing": {...}}``; ``stats.jsonl`` holds a
        ``ScalarLogger`` record a tick."""
        cfgt = cfg["train"]
        cfge = cfg.get("env") or {}
        seed = cfge.get("rnd_seed", 0) or 0
        log_dir = cfgt.get("log_dir") or "log/train"
        for key in ("eval_every_kimg", "profile_dir"):
            if cfgt.get(key):
                raise NotImplementedError(
                    f"train.{key}: the nested eval and the profiler hook "
                    "come with a later slice")
        n_dev = cfge.get("mesh_devices") or 1
        batch_size = cfgt.get("batch_size") or (
            cfgt["batch_size_per_gpu"] * n_dev)
        dev = resolve_device(device if device is not None
                             else cfge.get("device"))
        print_log(f"device: {dev}, train batch: {batch_size}"
                  + (f" (the global batch of {n_dev} devices on one)"
                     if n_dev > 1 else ""))

        dataset = get_dataset(cfgt["dataset"],
                              fallback_synthetic=cfge.get("debug", False))
        formatter = wrap_formatter(get_formatter(cfgt["dataset"]["formatter"]),
                                   cfgt["dataset"].get("transforms"))
        # remat is a TPU formulation: the models accept and ignore it
        G = get_model(cfg["model_g"], seed=seed).to(dev)
        D = get_model(cfg["model_d"], seed=derive_seed(seed, 1)).to(dev)
        tc = TrainConfig(**(cfgt.get("loss_kwargs") or {}))
        step = TrainStep(G, D, tc)

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
            # resume_itern is in kimg (it names the snapshot picked);
            # without it, progress comes from the restored step counter
            if cfgt.get("resume_itern") is not None:
                cur_nimg = int(cfgt["resume_itern"]) * 1000
            else:
                cur_nimg = step.step * batch_size
            print_log(f"resumed from {resume_path} at step {step.step}, "
                      f"{cur_nimg / 1e3:.3f} kimg")
        tick_start = cur_nimg

        pipe = TrainPipeline(dataset, formatter, batch_size, device=dev,
                             seed=seed, num_threads=_num_workers(cfgt),
                             start=cur_nimg // batch_size)
        step.timing = os.environ.get("SHGAN_TRAIN_TIMING") == "1"
        timing = {"step_s": [], "phase_s": [], "global_batch": batch_size}
        ticks, pending = [], []
        logger = ScalarLogger(log_dir,
                              tensorboard=cfgt.get("log_tensorboard", False))

        def grid(filename):
            draw_demo_grid(step.G_ema, dataset, formatter, log_dir, dev,
                           subfolder="demo", filename=filename)

        if image_ticks:
            grid("fakes_init.png")
        try:
            t_tick = t_prev = timeit.default_timer()
            it = iter(pipe)
            while cur_nimg < total_nimg:
                real, mask = next(it)
                step_i = cur_nimg // batch_size
                if on_step_start is not None:
                    on_step_start(step_i)
                metrics = step(real, mask, step_generator(seed, step_i),
                               compute_ema_beta(tc, batch_size, cur_nimg),
                               do_greg=step_i % tc.g_reg_interval == 0,
                               do_dreg=step_i % tc.d_reg_interval == 0)
                if on_step is not None:
                    on_step(step_i, metrics)
                # metrics stay on the device: one readback a tick
                pending.append(metrics)
                cur_nimg += batch_size
                now = timeit.default_timer()
                timing["step_s"].append(now - t_prev)
                t_prev = now
                if step.timing:
                    timing["phase_s"].append(dict(step.phase_s))
                if (cur_nimg >= tick_start + kimg_per_tick * 1000
                        or cur_nimg >= total_nimg):
                    # one readback for the tick's steps
                    keys = sorted(pending[0])
                    vals = torch.stack([
                        torch.stack([m[k].float() for k in keys])
                        for m in pending]).tolist()
                    pending.clear()
                    for v in vals:
                        logger.accumulate(dict(zip(keys, v)))
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
        self.save_snapshot(step, log_dir, cur_nimg)
        if image_ticks:
            grid("fakes{:06d}.png".format(cur_nimg // 1000))
        return {"step": step, "ticks": ticks, "timing": timing}

    @staticmethod
    def save_snapshot(step, log_dir, cur_nimg):
        path = osp.join(log_dir, "weight", snapshot_name(cur_nimg))
        save_train_state(path, step)
        print_log(f"saved snapshot {path}")
        return path
