"""The port's data-parallel training step (``TrainStep(mesh=...)`` over gloo
ranks of ``tests/torch_mh_driver.py``) against the benchmark's plain
reference (``benchmark/reference/training.py``) at the global batch, and the
spans and counters the ranks' collectives leave (``dist.grads``,
``dist.rows``; ``Mesh.traffic``).

One process group runs at a time, on a port reserved for it, within its own
deadline (``mh_launch``).

Tolerances of the reference comparison (4 ranks x 2 rows against one
process on 8 rows, float32 on the CPU): the ranks run every convolution
and matrix product at 2 rows where the reference runs them at 8, and the
CPU's kernels round some of those differently in the last bits; the
batch-wide statistics are gathered and then reduced as one process
reduces them.  Measured: the losses within 2.1e-7 relative (held to
1e-5); the first gradients within 1.3e-6 of the larger of a leaf's norm and
its network's median leaf's, 3.2e-7 of a network's norm (held to 1e-4 and
1e-5; a rank that took its own rows' statistics is off by far more).  A
leaf's change after Adam's first step is the learning rate times the sign
of its gradient almost everywhere (β1 = 0), so an element whose gradient
rounds across 0 moves the other way, by up to twice the learning rate:
measured within 8.4e-5 a leaf and 4.4e-5 a network (held to 1e-2 and
1e-3), over the leaves whose reference gradient is above a thousandth of
the median leaf's (below that, Adam moves a leaf by round-off alone: the
benchmark's own rule).  The replicas agree bit for bit.
"""

import json
import os.path as osp
import statistics
import sys

import numpy as np
import pytest
import torch

from mh_launch import Ranks, rank_env

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(HERE)
RANK_SCRIPT = osp.join(HERE, "torch_mh_driver.py")
sys.path.insert(0, osp.join(REPO, "benchmark", "tests"))
import tiny  # noqa: E402  (puts the benchmark's directory on the path)
from harness import inputs  # noqa: E402
from reference import training as ref  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_LEAF_TOL, GRAD_NET_TOL = 1e-4, 1e-5
CHANGE_LEAF_TOL, CHANGE_NET_TOL = 1e-2, 1e-3


def _env():
    return rank_env(1)


def _run(mode, out_dir, world):
    return Ranks(RANK_SCRIPT, world, [out_dir, mode], out_dir, _env(),
                 timeout=120).wait()


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(real, mask, seed):
    """The plain reference's step 0 on the rank driver's weights (drawn as
    the benchmark draws them from ``seed``), batch and seed: (losses, first
    gradients, state after the step, initial state)."""
    from shgan_torch.models.registry import get_model
    cfg = tiny.tiny_train()
    sds = {}
    for name, s in (("model_g", seed), ("model_d", seed + 1)):
        net = get_model(cfg[name], seed=s)
        tmpl = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in net.state_dict().items()}
        sds[name] = inputs.weights(tmpl, cfg[name], s, torch.device("cpu"))
    tr = ref.Trainer(cfg, sds["model_g"], sds["model_d"], torch.device("cpu"))
    losses = tr.step(torch.from_numpy(real), torch.from_numpy(mask), seed)
    init = {**{"G." + k: v for k, v in sds["model_g"].items()},
            **{"D." + k: v for k, v in sds["model_d"].items()},
            **{"G_ema." + k: v for k, v in sds["model_g"].items()}}
    return losses, tr.first_grads, tr.state(), init


def _gaps(got, want, keys):
    """Each key's ‖got − want‖ over the larger of ‖want‖ and its network's
    median ‖want‖, and each network's ‖got − want‖ / ‖want‖."""
    by = {}
    for k in keys:
        by.setdefault(k.split(".")[0], []).append(k)
    leaf, net = {}, {}
    for n, ks in by.items():
        norms = {k: float(np.linalg.norm(want[k])) for k in ks}
        med = statistics.median(norms.values())
        for k in ks:
            leaf[k] = float(np.linalg.norm(got[k] - want[k])) / max(
                norms[k], med, 1e-30)
        net[n] = float(np.sqrt(sum(np.sum((got[k] - want[k]) ** 2)
                                   for k in ks))) / max(float(np.sqrt(sum(
                                       norms[k] ** 2 for k in ks))), 1e-30)
    return leaf, net


def test_four_ranks_step_is_the_plain_reference_at_the_global_batch(
        tmp_path, one_thread):
    """4 ranks x 2 rows, one step with Gpl and R1, against the plain
    reference on the global batch of 8: the ranks' mean of the losses,
    the first gradients (Adam's exp_avg with β1 = 0: the averaged
    gradient), the change of every leaf; the replicas bit for bit."""
    out = str(tmp_path)
    _run("dp_reference", out, 4)
    ranks = [_npz(osp.join(out, f"dp_reference_rank{r}.npz"))
             for r in range(4)]
    for r in range(1, 4):
        for k in ranks[0]:
            if k.startswith("S_") or k == "pl_mean":
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                              err_msg=f"rank {r} {k}")
    got = ranks[0]
    losses, first, state, init = _reference(got["real"], got["mask"],
                                            int(got["seed"]))
    for name, want in losses.items():
        assert abs(float(got["L_" + name]) - want) <= LOSS_RTOL * abs(want), \
            (name, float(got["L_" + name]), want)

    want_g = {k: v.numpy() for k, v in first.items()}
    got_g = {k: got["F_" + k] for k in want_g}
    leaf, net = _gaps(got_g, want_g, list(want_g))
    assert max(leaf.values()) <= GRAD_LEAF_TOL, max(leaf.items(),
                                                     key=lambda kv: kv[1])
    assert max(net.values()) <= GRAD_NET_TOL, net

    med_g = {n: statistics.median(float(np.linalg.norm(v))
                                  for k, v in want_g.items()
                                  if k.startswith(n + "."))
             for n in ("G", "D")}
    moved = []
    for k in state:
        src = "G" + k[5:] if k.startswith("G_ema.") else k
        if src in want_g and (np.linalg.norm(want_g[src])
                              < 1e-3 * med_g[src.split(".")[0]]):
            continue
        moved.append(k)
    want_c = {k: (state[k] - init[k]).numpy() for k in moved}
    got_c = {k: got["S_" + k] - init[k].numpy() for k in moved}
    leaf, net = _gaps(got_c, want_c, [k for k in moved
                                      if np.any(want_c[k])])
    assert max(leaf.values()) <= CHANGE_LEAF_TOL, max(leaf.items(),
                                                       key=lambda kv: kv[1])
    assert max(net.values()) <= CHANGE_NET_TOL, net


def test_two_ranks_record_their_collectives(tmp_path):
    """2 ranks, one step with Gpl and R1 under a profiler: two ``dist.grads``
    spans (G's and D's all-reduce), each of 4 bytes a trainable parameter
    of its network, so ``grad_bytes`` is 4 x G's and D's trainable
    parameters; one ``dist.rows`` span for each count of ``rows_calls``,
    forward and backward, their bytes ``rows_bytes``; the same counts on
    both ranks."""
    out = str(tmp_path)
    _run("dp_spans", out, 2)
    recs = []
    for r in range(2):
        with open(osp.join(out, f"dp_spans_rank{r}.json")) as f:
            recs.append(json.load(f))
    for rec in recs:
        t = rec["traffic"]
        assert rec["steps"] == 1
        assert len(rec["grads"]) == 2 == t["grad_calls"]
        assert sum(rec["grads"]) == t["grad_bytes"] == 4 * rec["params"]
        assert t["rows_calls"] > 0 and len(rec["rows"]) == t["rows_calls"]
        assert sum(rec["rows"]) == t["rows_bytes"]
        assert t["halo_bytes"] == t["sum_bytes"] == 0
    assert recs[0]["traffic"] == recs[1]["traffic"]
    assert recs[0]["rows"] == recs[1]["rows"]


def test_one_rank_records_no_collective(one_thread):
    """Without a mesh (and on a mesh of one rank) the step records no
    ``dist.*`` span and counts nothing."""
    from torch.profiler import ProfilerActivity, profile
    from shgan_torch.main import build_config
    from shgan_torch.models.registry import get_model
    from shgan_torch.parallel import Mesh
    from shgan_torch.runtime import tracing
    from shgan_torch.runtime.stages import step_generator
    from shgan_torch.train import TrainConfig, TrainStep
    cfg = build_config("smoke_train", log_root="/nonexistent")
    G = get_model(cfg["model_g"], seed=0)
    D = get_model(cfg["model_d"], seed=1)
    tc = TrainConfig(**(cfg["train"].get("loss_kwargs") or {}))
    real = torch.rand(4, 3, 32, 32) * 2 - 1
    mask = (torch.rand(4, 1, 32, 32) > 0.4).float()
    mesh = Mesh()
    counts = dict(mesh.traffic)
    for m in (None, mesh):
        step = TrainStep(G, D, tc, mesh=m)
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            step(real, mask, step_generator(0, 0), 0.99, do_greg=True,
                 do_dreg=True)
        names = {r.name for r in tracing.spans()}
        assert "train.step" in names
        assert not any(n.startswith("dist.") for n in names), names
    mesh.average_grads(list(G.parameters()))
    assert mesh.traffic == counts and not any(counts.values())
