"""Driver of the training loop, as ``runtime/stages.train_stage`` runs it:
a batch from ``data/pipeline.TrainPipeline`` (its prefetch threads decode
PNGs), the step's generator ``step_generator(seed, step)``, the lazy
schedule (the path-length penalty on steps = 0 mod ``g_reg_interval``,
R1 on steps = 0 mod ``d_reg_interval``), ``TrainStep``, and one metric
readback a tick.

The data are PNGs the run writes from its seed into a directory under
``TMPDIR`` (photo-like images, and CoModGAN's free-form masks as the
``FixedMaskFormatter``'s mask files), removed at the end.  Set-up drives
the step object from the seed through steps 0 to 15 (one of each kind);
it keeps what the check compares of the first three (each step's losses,
the first gradient as the optimizers got it, each leaf's change after
three steps) and hands the same object to the window, which starts at step
16 and runs whole 16-step cycles until ``--seconds`` have passed, then
waits for the device: images of all steps over all that time.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch
from PIL import Image
from torch.profiler import record_function

from harness import inputs
from harness.trace import profiled
from reference import training as ref

CYCLE = 16


def _norms(tensors):
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.cfg = cell.config
        self.seed = cell.seed % (2 ** 31)
        self.dir = None

    # -- data -------------------------------------------------------------
    def _write_data(self):
        t = self.cell.traffic
        res = self.cfg["model_g"]["args"]["synthesis"]["args"]["resolution"]
        self.dir = tempfile.mkdtemp(prefix="shgan_bench_")
        img_dir = os.path.join(self.dir, "images")
        mask_dir = os.path.join(self.dir, "masks")
        os.makedirs(img_dir)
        os.makedirs(mask_dir)
        rng = np.random.RandomState(self.seed)
        for i in range(int(t["images"])):
            Image.fromarray(inputs.photo(rng, res).transpose(1, 2, 0)).save(
                os.path.join(img_dir, f"{i:05d}.png"), compress_level=1)
            m = inputs.free_form_mask(rng, res, tuple(t["hole_range"]))
            Image.fromarray(m * 255).save(
                os.path.join(mask_dir, f"{i:05d}_mask.png"), compress_level=1)
        return img_dir, mask_dir

    def batch(self, k):
        """The reference's batch of step ``k`` from the same files: the
        pipeline's epoch-0 order (``RandomState(seed).permutation``)."""
        n = int(self.cell.traffic["images"])
        bs = self.cfg["train"]["batch_size"]
        idx = np.random.RandomState(self.seed).permutation(n)[k * bs:(k + 1) * bs]
        reals, masks = [], []
        for i in idx:
            with Image.open(os.path.join(self.img_dir, f"{i:05d}.png")) as im:
                img = np.asarray(im.convert("RGB"))
            reals.append(img.transpose(2, 0, 1).astype(np.float32) / 255.0
                         * 2 - 1)
            with Image.open(os.path.join(self.mask_dir,
                                         f"{i:05d}_mask.png")) as im:
                masks.append((np.asarray(im.convert("L")) > 128)
                              .astype(np.float32))
        dev = self.cell.device
        return (torch.from_numpy(np.stack(reals)).to(dev),
                torch.from_numpy(np.stack(masks)[:, None]).to(dev))

    # -- the program --------------------------------------------------------
    def _weights(self, module, model, seed):
        tmpl = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in module.state_dict().items()}
        return tmpl, inputs.weights(tmpl, model, seed, self.cell.device)

    def setup(self):
        from shgan_torch.data.datasets import get_dataset
        from shgan_torch.data.formatters import get_formatter
        from shgan_torch.data.pipeline import TrainPipeline
        from shgan_torch.models.registry import get_model
        from shgan_torch.runtime.stages import step_generator
        from shgan_torch.train import TrainConfig, TrainStep
        from shgan_torch.train.step import compute_ema_beta
        dev, tr = self.cell.device, self.cfg["train"]
        self.step_generator, self.ema_beta = step_generator, compute_ema_beta
        self.img_dir, self.mask_dir = self._write_data()
        G = get_model(self.cfg["model_g"], seed=self.seed).to(dev)
        D = get_model(self.cfg["model_d"], seed=self.seed + 1).to(dev)
        self.tmpl_g, sd_g = self._weights(G, self.cfg["model_g"], self.seed)
        self.tmpl_d, sd_d = self._weights(D, self.cfg["model_d"],
                                          self.seed + 1)
        G.load_state_dict(sd_g, strict=True)
        D.load_state_dict(sd_d, strict=True)
        self.tc = TrainConfig(**tr["loss_kwargs"])
        self.step = TrainStep(G, D, self.tc)
        ds = get_dataset({"type": "imagedir", "root_dir": self.img_dir})
        fmt = get_formatter({"type": "FixedMaskFormatter",
                             "args": {"mask_dir": self.mask_dir}})
        self.pipe = TrainPipeline(ds, fmt, tr["batch_size"], device=dev,
                                  seed=self.seed,
                                  num_threads=tr["num_workers"])
        self.it = iter(self.pipe)
        self.k = 0
        self.pending, self.wait_s = [], []
        # steps 0-2: what the check compares
        first = {}
        init = {**{"G." + k: v for k, v in sd_g.items()},
                **{"D." + k: v for k, v in sd_d.items()},
                **{"G_ema." + k: v for k, v in sd_g.items()}}
        self.losses = []
        for k in range(3):
            m = self.run_steps(1)[0]
            self.losses.append({n: float(v) for n, v in m.items()})
            if k == 0:
                for net, opt, mod in (("G", self.step.opt_g, G),
                                      ("D", self.step.opt_d, D)):
                    for name, p in mod.named_parameters():
                        if p in opt.state:
                            first[f"{net}.{name}"] = opt.state[p]["exp_avg"]
                self.first_grads = _norms(first)
        now = self._state()
        self.changes = {k: float((now[k].float() - init[k].float()).norm())
                        for k in now}
        del init, first, sd_g, sd_d, now
        # steps 3-15: the rest of the first cycle, each kind of step warm
        self.run_steps(CYCLE - 3)
        torch.cuda.synchronize() if dev.type == "cuda" else None

    def _state(self):
        s = self.step
        return {**{"G." + k: v for k, v in s.G.state_dict().items()},
                **{"D." + k: v for k, v in s.D.state_dict().items()},
                **{"G_ema." + k: v for k, v in s.G_ema.state_dict().items()}}

    def run_steps(self, count):
        """``count`` steps as the train stage runs them; returns their
        metrics (on the device)."""
        tc, bs = self.tc, self.cfg["train"]["batch_size"]
        tick = self.cfg["train"]["kimg_per_tick"] * 1000
        out = []
        for _ in range(count):
            k = self.k
            t = time.perf_counter()
            with record_function("bench.wait_batch"):
                real, mask = next(self.it)
            self.wait_s.append(time.perf_counter() - t)
            m = self.step(real, mask, self.step_generator(self.seed, k),
                          self.ema_beta(tc, bs, k * bs),
                          do_greg=k % tc.g_reg_interval == 0,
                          do_dreg=k % tc.d_reg_interval == 0)
            out.append(m)
            self.pending.append(m)
            self.k += 1
            if (self.k * bs) % tick == 0:
                # the stage's one readback a tick
                keys = sorted(self.pending[0])
                torch.stack([torch.stack([p[n].float() for n in keys])
                             for p in self.pending]).tolist()
                self.pending.clear()
        return out

    def window(self, tracing):
        cell, t = self.cell, self.cell.traffic
        bs = self.cfg["train"]["batch_size"]
        self.wait_s = []
        steps = 0
        with profiled(tracing) as prof:
            with record_function("bench.window"):
                t0 = cell.start_window()
                deadline = t0 + cell.seconds
                while True:
                    self.run_steps(CYCLE)
                    steps += CYCLE
                    if tracing and steps >= CYCLE * int(t.get("trace_cycles",
                                                              1)):
                        break
                    if not tracing and time.perf_counter() >= deadline:
                        break
                if cell.device.type == "cuda":
                    torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
        self.log(f"train loop: {steps} steps ({steps // CYCLE} cycles) in "
                 f"{elapsed:.3f} s; mean batch wait "
                 f"{statistics.mean(self.wait_s) * 1e3:.3f} ms")
        return {"e2e": {"train_images_per_s": steps * bs / elapsed},
                "attempted": steps, "failed": 0, "trace": prof.trace,
                "facts": {"steps": steps, "seconds": elapsed, "batch": bs,
                          "wait_s": list(self.wait_s)}}

    def release(self):
        self.step = self.pipe = self.it = self.pending = None
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    def check(self):
        dev = self.cell.device
        limits = self.cell.settings["limits"]
        tf = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            sd_g = inputs.weights(self.tmpl_g, self.cfg["model_g"], self.seed,
                                  dev)
            sd_d = inputs.weights(self.tmpl_d, self.cfg["model_d"],
                                  self.seed + 1, dev)
            init = {**{"G." + k: v for k, v in sd_g.items()},
                    **{"D." + k: v for k, v in sd_d.items()},
                    **{"G_ema." + k: v for k, v in sd_g.items()}}
            tr = ref.Trainer(self.cfg, sd_g, sd_d, dev)
            losses = [tr.step(*self.batch(k), self.seed) for k in range(3)]
            want_g = _norms(tr.first_grads)
            st = tr.state()
            want_c = {k: float((st[k] - init[k]).norm()) for k in st}
        finally:
            torch.backends.cudnn.allow_tf32, \
                torch.backends.cuda.matmul.allow_tf32 = tf
            shutil.rmtree(self.dir, ignore_errors=True)
        for k, (got, want) in enumerate(zip(self.losses, losses)):
            self.log(f"step {k} losses: " + ", ".join(
                f"{n} {got[n]!r} (reference {want[n]!r})" for n in want))
        return compare(self.losses, losses, self.first_grads, want_g,
                       self.changes, want_c, limits, self.log)


def compare(got_l, want_l, got_g, want_g, got_c, want_c, limits,
            log=lambda s: None):
    """The numbers compared: the worst relative gap of the first step's
    losses (the later steps' losses read the chaotic sensitivity of a
    random-init GAN to Adam's sign-like first update, and are logged only);
    the worst leaf's gap of its first-gradient norm and of its change after
    three steps, each over the larger of the reference's norm of the leaf
    and of the median leaf of its network.  A leaf whose reference
    gradient is under a thousandth of the median leaf's (it moves under
    Adam by round-off alone) is left out of the change."""
    loss = max(abs(got_l[0][n] - w) / max(abs(w), 1e-12)
               for n, w in want_l[0].items())
    later = max(abs(g[n] - w[n]) / max(abs(w[n]), 1e-12)
                for g, w in zip(got_l[1:], want_l[1:]) for n in w)
    log(f"later steps' losses: worst relative gap {later!r}")

    def net(k):
        return k.split(".")[0]

    def gaps(got, want, keys):
        by = {}
        for k in keys:
            by.setdefault(net(k), []).append(k)
        med = {n: statistics.median(want[k] for k in ks)
               for n, ks in by.items()}
        return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med[net(k)])
                for k in keys}, med

    g_gap, med_g = gaps(got_g, want_g, list(want_g))
    moved = []
    for k in want_c:
        src = "G" + k[5:] if k.startswith("G_ema.") else k
        if src in want_g and want_g[src] < 1e-3 * med_g[net(src)]:
            continue
        if want_c[k] == 0.0 and got_c.get(k, 0.0) == 0.0:
            continue
        moved.append(k)
    c_gap, _ = gaps(got_c, want_c, moved)
    for name, gp, got, want in (("first-gradient", g_gap, got_g, want_g),
                                ("change", c_gap, got_c, want_c)):
        worst = sorted(gp, key=lambda k: -gp[k])[:3]
        log(f"worst {name} leaves: " + ", ".join(
            f"{k} {got.get(k)!r} (reference {want[k]!r})" for k in worst))
    return [("loss_gap", loss, limits["loss_gap"]),
            ("grad_gap", max(g_gap.values()), limits["grad_gap"]),
            ("change_gap", max(c_gap.values()), limits["change_gap"])]
