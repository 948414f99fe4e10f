"""The no-grad route of the co-modulated synthesis (``models/synthesis.py``)
on the CPU: each synthesis layer's epilogue writes its consumers' inputs
(the encoder skip added, each consumer's ``x * styles``) and those
consumers skip their own multiply.  A ``CoModSynthesis`` at 64² with tiny
channels is held bit for bit to the same forward recording a gradient
(today's path): the two are told apart only by grad mode.  The counter
``kernels/build.modconv`` says which modulated convs were prescaled.  A
training step takes the route in its D phase, whose generator forward runs
under ``no_grad``, and equals the same step with the route patched off.
"""

import importlib
import os.path as osp
import sys

import numpy as np
import pytest
import torch

from shgan_torch.kernels import build
from shgan_torch.models.layers import SynthesisLayer
from shgan_torch.models.synthesis import CoModSynthesis, CoModSynthesisPlur
from shgan_torch.ops import noise_bias_act as nba
from shgan_torch.ops.noise import noise_table

RES = 64
BLOCKS = int(np.log2(RES)) - 1   # 4² ... 64²
W_DIM = W0_DIM = 16


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _synthesis(cls=CoModSynthesis, fp16_after=None, seed=0):
    s = cls(w_dim=W_DIM, w0_dim=W0_DIM, resolution=RES, rgb_n=3,
            ch_base=256, ch_max=8, use_fp16_after_res=fp16_after,
            generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in s.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
            elif name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return s


def _inputs(s, n=2, seed=2):
    g = torch.Generator().manual_seed(seed)
    ch = lambda r: min(256 // r, 8)  # noqa: E731
    x = torch.randn(n, W0_DIM, generator=g)
    feats = {r: torch.randn(n, ch(r), r, r, generator=g)
             for r in s.block_res}
    ws = torch.randn(n, s.num_ws, W_DIM, generator=g)
    return x, feats, ws


def _noise_seed(s, mode):
    if mode != "random":
        return None
    ids = [m.layer_id for m in s.modules() if isinstance(m, SynthesisLayer)]
    return noise_table(11, ids, row0=3)


def _run(s, args, mode, grad, **kw):
    """The forward with grad mode ``grad`` and the modulated convs'
    counts over it."""
    build.reset_launches()
    with torch.set_grad_enabled(grad):
        img = s(*args, noise_mode=mode, noise_seed=_noise_seed(s, mode),
                **kw)
    return img.detach(), build.snapshot_modconv()


@pytest.mark.parametrize("mode", ["const", "random"])
def test_route_is_todays_path_bit_for_bit(mode):
    s = _synthesis()
    args = _inputs(s)
    got, on = _run(s, args, mode, grad=False)
    want, off = _run(s, args, mode, grad=True)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    assert on == {"prescaled": 3 * BLOCKS - 2, "multiplied": 1}
    assert off == {"prescaled": 0, "multiplied": 3 * BLOCKS - 1}


def test_route_of_the_pluralistic_variant():
    s = _synthesis(CoModSynthesisPlur, seed=4)
    x, feats, ws = _inputs(s)
    w0_noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    got, on = _run(s, (x, feats, ws), "const", grad=False, w0_noise=w0_noise)
    want, _ = _run(s, (x, feats, ws), "const", grad=True, w0_noise=w0_noise)
    assert torch.equal(got, want)
    assert on["prescaled"] == 3 * BLOCKS - 2


def test_bf16_blocks_fold_all_but_the_cast():
    """Blocks above 16² in bf16: the 16² block's last epilogue folds
    nothing (the 32² block casts its input first), so its torgb and the
    32² conv0 multiply for themselves; the rest is bit for bit."""
    s = _synthesis(fp16_after=16, seed=6)
    args = _inputs(s, seed=7)
    got, on = _run(s, args, "const", grad=False)
    want, _ = _run(s, args, "const", grad=True)
    assert torch.equal(got, want)
    assert on == {"prescaled": 3 * BLOCKS - 4, "multiplied": 3}


def test_route_without_parameters_that_need_a_gradient():
    """Grad mode on, but nothing needs a gradient (a frozen copy, as
    G_ema): the route, as ops/conv1024.takes_k3 decides."""
    s = _synthesis().requires_grad_(False)
    args = _inputs(s)
    got, on = _run(s, args, "none", grad=True)
    want, _ = _run(_synthesis(), args, "none", grad=True)
    assert torch.equal(got, want)
    assert on["prescaled"] == 3 * BLOCKS - 2
    # an input that needs a gradient takes today's path
    x, feats, ws = args
    _, off = _run(s, (x, feats, ws.clone().requires_grad_(True)), "none",
                  grad=True)
    assert off["prescaled"] == 0


def test_the_fold_refuses_a_gradient():
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        nba.noise_bias_act(x, addend=torch.zeros(2, 3, 4, 4),
                           scales=(torch.ones(2, 3),))
    with pytest.raises(RuntimeError, match="no gradient"):
        nba.noise_bias_act(x, scales=(torch.ones(2, 3),))
    with torch.no_grad():
        y, = nba.noise_bias_act(x, scales=(torch.full((2, 3), 2.0),))
    assert torch.equal(y, x.detach() * 2)


# ---- training: the D phase's generator forward takes the route ------------

def _smoke():
    """``chip_smoke.py``, whose count rule the tests hold the port to."""
    sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
    return importlib.import_module("chip_smoke")


TRAIN_RES = 16
TRAIN_BLOCKS = int(np.log2(TRAIN_RES)) - 1


def _train_step(route, monkeypatch, accum=1, bf16=False, remat=False):
    """One step with Gpl and R1 of the tiny G and D at 16² (every noise
    strength 0.3), the route on or patched off: the step's metrics, the
    weights of G, D and G_ema, the modulated convs' counts of each D-phase
    generator forward and of the whole step."""
    from shgan_torch.models import get_model
    from shgan_torch.runtime.stages import remat_configs
    from shgan_torch.train import TrainConfig, TrainStep
    from shgan_torch.train import loss as TL
    from test_torch_models import tiny_cfg
    from test_torch_train_ops import tiny_d_cfg
    cg, cd = tiny_cfg(TRAIN_RES), tiny_d_cfg(TRAIN_RES)
    if bf16:
        cg["args"]["synthesis"]["args"]["use_fp16_after_res"] = 8
    if remat:
        cg, cd = remat_configs(cg, cd)
    G, D = get_model(cg, seed=0), get_model(cd, seed=1)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    if not route:
        monkeypatch.setattr(CoModSynthesis, "on_route",
                            lambda *a, **k: False)
    d_phase, d_main = [], TL.d_main_loss

    def counted(*a, **k):
        before = build.snapshot_modconv()
        out = d_main(*a, **k)
        after = build.snapshot_modconv()
        d_phase.append({k: after[k] - before[k] for k in after})
        return out
    monkeypatch.setattr(TL, "d_main_loss", counted)
    g = torch.Generator().manual_seed(0)
    real = torch.rand(4, 3, TRAIN_RES, TRAIN_RES, generator=g) * 2 - 1
    mask = (torch.rand(4, 1, TRAIN_RES, TRAIN_RES, generator=g)
            > 0.5).float()
    step = TrainStep(G, D, TrainConfig(grad_accum=accum))
    build.reset_launches()
    metrics = step(real, mask, torch.Generator().manual_seed(1), 0.9, True,
                   True)
    whole = build.snapshot_modconv()
    build.reset_launches()
    monkeypatch.undo()
    weights = [{k: v.clone() for k, v in m.state_dict().items()}
               for m in (G, D, step.G_ema)]
    return metrics, weights, d_phase, whole, G.synthesis


@pytest.mark.parametrize("accum,bf16,remat", [
    (1, False, False), (2, False, False), (1, True, False), (1, False, True)],
    ids=["float32", "accum2", "bf16", "remat"])
def test_train_step_takes_the_route_in_the_d_phase(monkeypatch, accum, bf16,
                                                   remat):
    """``train/loss.d_main_loss`` runs G under ``no_grad``, so each D-phase
    generator forward takes the route: 3L-2 prescaled and 1 multiplied for
    L blocks (with bf16 blocks above 8², the cast at 16² makes 2 more
    multiply); the G phase (Gmain, Gpl) records a gradient and multiplies
    in every modulated conv (with ``remat`` its recomputes too).  The step
    equals the same step with the route
    patched off bit for bit: metrics and the weights of G, D and G_ema."""
    got = _train_step(True, monkeypatch, accum, bf16, remat)
    want = _train_step(False, monkeypatch, accum, bf16, remat)
    multiplied = 3 if bf16 else 1
    per_d = {"prescaled": 3 * TRAIN_BLOCKS - 1 - multiplied,
             "multiplied": multiplied}
    convs = 3 * TRAIN_BLOCKS - 1
    assert got[2] == [per_d] * accum
    assert want[2] == [{"prescaled": 0, "multiplied": convs}] * accum
    # only the D phase's convs change sides (remat's recomputes in the G
    # phase's backward multiply on both)
    assert got[3]["prescaled"] == accum * per_d["prescaled"]
    assert got[3]["prescaled"] + got[3]["multiplied"] == \
        want[3]["multiplied"]
    if not remat:
        assert got[3]["multiplied"] == accum * (2 * convs + multiplied)
        # chip_smoke.py's rule for a training step
        assert got[3] == _smoke().train_modconv(got[4], True, accum)
    for k, v in want[0].items():
        assert torch.equal(got[0][k], v), k
    for a, b in zip(got[1], want[1]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
