"""Driver of data-parallel training over the ranks of one host, as
``runtime/stages.train_stage`` runs its ranks: each rank joins the process
group from torchrun's variables (``parallel/multihost.
maybe_initialize_distributed``), makes the mesh (``create_mesh``: NCCL
between the cards, the host's gloo beside it), takes its rows of each
global batch from ``TrainPipeline(rows=mesh.batch_rows(...))`` and steps
``TrainStep(..., mesh=mesh)`` with the global batch's draws.

Rank 0 runs in the benchmark's own process on the run's device, so the
window, the trace and the device's facts are the run's; ranks 1 to W - 1 are
child processes of ``train_dp_rank.py``, on the next cards, started once
rank 0 has built or loaded the kernels (no two processes build at once) and
written the PNGs, which every rank reads.  Each rank drives the steps as
``train_loop`` does (set-up: steps 0 to 15; the window: whole 16-step
cycles, one metric readback a tick, the ranks' mean as the stage logs it);
at each cycle's end rank 0 says whether the window goes on and the ranks
agree on it over the host's group, between steps.  ``train_images_per_s``
counts every rank's images: the global batch a step.  ``facts["batch"]`` is
one rank's rows, so the per-card readers read one card, and
``facts["traffic"]`` holds the mesh's counters over the window (none where
the program keeps none).

The check: after the window every rank's G, D, G_ema (``w_avg`` among G's
buffers) and ``pl_mean`` must equal rank 0's bit for bit (``replica_gap``:
the tensors ``parallel/consistency.check_replicated`` finds apart); then,
every rank's state freed and the children gone, rank 0's card recomputes
steps 0 to 2 with the plain reference at the global batch, from the same
PNGs and seed, compared as ``train_loop`` compares one rank: the ranks' mean
of step 0's losses, Adam's ``exp_avg`` after step 0 (the averaged
gradient), each leaf's change after three steps.  A child that loaded JAX
or the JAX package fails the run.

A watchdog thread ends the run when a child fails, when the run outlives
its deadline (rank 0 kills the children first), or, in a child, when rank 0
is gone: a program that cannot run the cell fails within minutes.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import torch
from torch.profiler import record_function

from harness import runner
from harness.trace import profiled

HERE = Path(__file__).resolve().parent
train_loop = runner.load_module(HERE / "train_loop.py", "train_dp_loop")
CYCLE = train_loop.CYCLE
# beside the harness, which it imports
RANK_SCRIPT = runner.HERE / "traffic" / "train_dp_rank.py"
# seconds a rank may wait for its peers in one collective or at the join
JOIN_S = 300
# the watchdog's deadlines: set-up (kernels, PNGs, the ranks' start and
# join, 16 steps), the window beyond its seconds (the last cycle), and the
# end (the replica check, the exit, the reference's three steps)
SETUP_S, WINDOW_S, END_S = 480, 180, 480
# seconds rank 0 waits for the children to exit after the window
EXIT_S = 120
TAIL = 4000


def _fatal(method):
    """Run a phase; at an error print it, kill the children and end the
    process at once (a process group left half-joined can hang the
    interpreter's exit)."""
    @functools.wraps(method)
    def run(self, *a, **kw):
        try:
            return method(self, *a, **kw)
        except Exception:
            self.log(f"train_dp rank {self.rank}: {traceback.format_exc()}")
            if self.rank == 0:
                self._kill_children()
                self.log(self._children_tails())
            sys.stderr.flush()
            os._exit(1)
    return run


def _tail(path):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-TAIL:]
    except OSError:
        return ""


class Driver(train_loop.Driver):
    """One rank's driver: ``rank`` 0 in the benchmark's process (it starts
    the others), or a child given the PNGs' directory ``data``."""

    def __init__(self, cell, log, rank=0, data=None):
        super().__init__(cell, log)
        tr = dict(self.cfg["train"])
        self.world = int(tr["ranks"])
        self.per_rank = int(tr["batch_size_per_gpu"])
        tr["batch_size"] = self.world * self.per_rank   # the global batch
        self.cfg = dict(self.cfg, train=tr)
        self.rank = rank
        self.children, self.logs = [], []
        self.deadline = cell.t_start + SETUP_S
        self.mesh = self.port = None
        self.replica_gap, self.foreign = None, []
        self._done = threading.Event()
        if data is not None:
            self.dir = data
            self.img_dir = os.path.join(data, "images")
            self.mask_dir = os.path.join(data, "masks")

    # -- the ranks ---------------------------------------------------------
    def _rank_env(self, rank):
        """torchrun's variables for ``rank`` on this host."""
        return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(self.port),
                "WORLD_SIZE": str(self.world), "RANK": str(rank),
                "LOCAL_RANK": str(rank)}

    def _start_ranks(self):
        """Reserve the coordinator's port (held until the group has
        joined), then start ranks 1 to W - 1."""
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self.port = self._sock.getsockname()[1]
        manifest = os.path.join(self.dir, "manifest.json")
        with open(manifest, "w") as f:
            json.dump(self.cell.manifest, f)
        c = self.cell
        for r in range(1, self.world):
            log = os.path.join(self.dir, f"rank{r}.log")
            self.logs.append(log)
            with open(log, "w") as out:
                self.children.append(subprocess.Popen(
                    [sys.executable, str(RANK_SCRIPT), "--manifest", manifest,
                     "--root", str(c.root), "--workload", c.name,
                     "--seed", str(c.seed), "--seconds", str(c.seconds),
                     "--rank", str(r), "--data", self.dir,
                     "--device", c.device.type],
                    env={**os.environ, **self._rank_env(r)}, stdout=out,
                    stderr=subprocess.STDOUT))
        os.environ.update(self._rank_env(0))

    def _kill_children(self):
        for p in self.children:
            if p.poll() is None:
                p.kill()

    def _children_tails(self):
        return "\n".join(f"--- rank {r + 1} (exit {p.poll()})\n"
                         f"{_tail(log)}" for r, (p, log) in enumerate(
                             zip(self.children, self.logs)))

    def _watch(self):
        """The watchdog: rank 0 ends the run at a child's failure or at the
        deadline; a child ends itself when rank 0 is gone or at the
        deadline."""
        parent = os.getppid()

        def fail(why):
            self.log(f"train_dp rank {self.rank}: {why}; ending the run")
            if self.rank == 0:
                self._kill_children()
                self.log(self._children_tails())
            os._exit(1)

        def loop():
            while not self._done.wait(1.0):
                if time.perf_counter() > self.deadline:
                    fail("a phase outlived its deadline")
                if self.rank == 0:
                    bad = [p.poll() for p in self.children
                           if p.poll() not in (None, 0)]
                    if bad:
                        fail(f"a rank exited with {bad[0]}")
                elif os.getppid() != parent:
                    fail("rank 0 is gone")

        threading.Thread(target=loop, daemon=True).start()

    # -- the program --------------------------------------------------------
    @_fatal
    def setup(self):
        from shgan_torch.data.datasets import get_dataset
        from shgan_torch.data.formatters import get_formatter
        from shgan_torch.data.pipeline import TrainPipeline
        from shgan_torch.models.registry import get_model
        from shgan_torch.parallel import (check_replicated, create_mesh,
                                          maybe_initialize_distributed)
        from shgan_torch.runtime.stages import step_generator
        from shgan_torch.train import TrainConfig, TrainStep
        from shgan_torch.train.step import compute_ema_beta
        dev, tr = self.cell.device, self.cfg["train"]
        self.step_generator, self.ema_beta = step_generator, compute_ema_beta
        if self.rank == 0:
            if dev.type == "cuda":
                from shgan_torch.kernels import build
                build.build_all()
            self.img_dir, self.mask_dir = self._write_data()
            self._start_ranks()
        self._watch()
        maybe_initialize_distributed(device=dev, timeout_s=JOIN_S)
        self.mesh = mesh = create_mesh(device=dev)
        if self.rank == 0:
            self._sock.close()
        self.log(f"train_dp rank {self.rank}: {mesh}")
        G = get_model(self.cfg["model_g"], seed=self.seed).to(dev)
        D = get_model(self.cfg["model_d"], seed=self.seed + 1).to(dev)
        self.tmpl_g, sd_g = self._weights(G, self.cfg["model_g"], self.seed)
        self.tmpl_d, sd_d = self._weights(D, self.cfg["model_d"],
                                          self.seed + 1)
        G.load_state_dict(sd_g, strict=True)
        D.load_state_dict(sd_d, strict=True)
        check_replicated([G, D], mesh=mesh)
        self.tc = TrainConfig(**tr["loss_kwargs"])
        self.step = TrainStep(G, D, self.tc, mesh=mesh)
        ds = get_dataset({"type": "imagedir", "root_dir": self.img_dir})
        fmt = get_formatter({"type": "FixedMaskFormatter",
                             "args": {"mask_dir": self.mask_dir}})
        self.pipe = TrainPipeline(
            ds, fmt, tr["batch_size"], device=dev, seed=self.seed,
            num_threads=tr["num_workers"],
            rows=mesh.batch_rows(tr["batch_size"], self.tc.grad_accum))
        self.it = iter(self.pipe)
        self.k = 0
        self.pending, self.wait_s = [], []
        # steps 0-2: what the check compares (rank 0 keeps it)
        init = {**{"G." + k: v for k, v in sd_g.items()},
                **{"D." + k: v for k, v in sd_d.items()},
                **{"G_ema." + k: v for k, v in sd_g.items()}}
        self.losses = []
        for k in range(3):
            m = self.run_steps(1)[0]
            keys = sorted(m)
            mean = mesh.all_reduce_mean_(
                torch.stack([m[n].float() for n in keys])).tolist()
            self.losses.append(dict(zip(keys, mean)))
            if k == 0:
                first = {}
                for net, opt, mod in (("G", self.step.opt_g, G),
                                      ("D", self.step.opt_d, D)):
                    for name, p in mod.named_parameters():
                        if p in opt.state:
                            first[f"{net}.{name}"] = opt.state[p]["exp_avg"]
                self.first_grads = train_loop._norms(first)
                del first
        if self.rank == 0:
            now = self._state()
            self.changes = {k: float((now[k].float() - init[k].float())
                                     .norm()) for k in now}
            del now
        del init, sd_g, sd_d
        # steps 3-15: the rest of the first cycle, each kind of step warm
        self.run_steps(CYCLE - 3)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run_steps(self, count):
        """``count`` steps as the train stage runs them on a rank (the
        tick's readback the ranks' mean); returns their metrics."""
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
                keys = sorted(self.pending[0])
                self.mesh.all_reduce_mean_(torch.stack([
                    torch.stack([p[n].float() for n in keys])
                    for p in self.pending])).tolist()
                self.pending.clear()
        return out

    def _go_on(self, done):
        """Rank 0's ``done``, agreed by every rank over the host's group."""
        import torch.distributed as dist
        flag = torch.tensor([int(bool(done))])
        dist.broadcast(flag, 0)
        return not bool(flag.item())

    @_fatal
    def window(self, tracing):
        cell, t = self.cell, self.cell.traffic
        self.deadline = time.perf_counter() + cell.seconds + WINDOW_S
        bs = self.cfg["train"]["batch_size"]
        self.wait_s = []
        steps = 0
        before = dict(self.mesh.traffic)
        with profiled(tracing and self.rank == 0) as prof:
            with record_function("bench.window"):
                t0 = cell.start_window()
                deadline = t0 + cell.seconds
                while True:
                    self.run_steps(CYCLE)
                    steps += CYCLE
                    done = (steps >= CYCLE * int(t.get("trace_cycles", 1))
                            if tracing else
                            time.perf_counter() >= deadline)
                    if not self._go_on(done):
                        break
                if cell.device.type == "cuda":
                    torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
        traffic = {k: v - before[k] for k, v in self.mesh.traffic.items()
                   if k in before}
        self.log(f"train_dp rank {self.rank}: {steps} steps "
                 f"({steps // CYCLE} cycles) in {elapsed:.3f} s; mean batch "
                 f"wait {statistics.mean(self.wait_s) * 1e3:.3f} ms; "
                 f"traffic {traffic}")
        return {"e2e": {"train_images_per_s": steps * bs / elapsed},
                "attempted": steps, "failed": 0, "trace": prof.trace,
                "facts": {"steps": steps, "seconds": elapsed,
                          "batch": self.per_rank, "ranks": self.world,
                          "wait_s": list(self.wait_s), "traffic": traffic}}

    @_fatal
    def release(self):
        """Every rank: the replica check, whether it loaded JAX, its state
        freed; then the group goes and rank 0 waits for the children."""
        import torch.distributed as dist
        from shgan_torch.parallel import check_replicated
        self.deadline = time.perf_counter() + END_S
        s = self.step
        try:
            check_replicated([s.G, s.D, s.G_ema, s.pl_mean], mesh=self.mesh)
            gap = 0.0
        except AssertionError as e:
            self.log(f"train_dp rank {self.rank}: {e}")
            gap = float(str(e).split()[0])
        bad = [None] * self.world
        dist.all_gather_object(bad, runner.forbidden_modules())
        self.replica_gap = gap
        self.foreign = sorted({m for b in bad for m in b})
        self.step = self.pipe = self.it = self.pending = None
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        if self.rank != 0:
            self._done.set()
            return
        for k in self._rank_env(0):
            os.environ.pop(k, None)
        end = time.perf_counter() + EXIT_S
        for p in self.children:
            try:
                p.wait(timeout=max(end - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                pass
        codes = [p.poll() for p in self.children]
        if any(c != 0 for c in codes):
            self._kill_children()
            self.log(self._children_tails())
            raise RuntimeError(f"ranks 1-{self.world - 1} ended with {codes}")

    # -- the check ------------------------------------------------------------
    @_fatal
    def check(self):
        try:
            if self.foreign:
                raise RuntimeError("a rank loaded modules of JAX or the JAX "
                                   f"package: {self.foreign}")
            checks = super().check()
        finally:
            self._done.set()
        limits = self.cell.settings["limits"]
        return checks + [("replica_gap", self.replica_gap,
                          limits["replica_gap"])]

