"""Kernel K3's route in the serving engine, on the CPU (where the route
runs K3's plain version): ``shgan_g1024``'s channel plan at a tiny width
served at 1024², against the benchmark's plain reference
(``benchmark/reference/generator.py``); the route is the engine's own
(K3 whatever the caller's grad mode); and a replay adds the capture's K3
launches to the counts once."""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import generator as ref
from shgan_torch.kernels import build
from shgan_torch.ops import conv1024
from shgan_torch.runtime import config as rcfg
from shgan_torch.runtime import tracing
from shgan_torch.serve import InpaintEngine

RES = 1024
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    """shgan_g1024 of the model bank (18 ws, SHU at 64²) at a tiny width:
    ch_base 2048 and ch_max 16 give the 1024² level 2 channels, so its two
    3×3 stride-1 convs are K3's; the SHU hints 4 of the 16 channels."""
    m = copy.deepcopy(rcfg.model_cfg_bank()("shgan_g1024"))
    a = m["args"]
    a["mapping"]["args"].update(z_dim=16, w_dim=16)
    a["encoder"]["args"].update(ch_base=2048, ch_max=16, oc_n=16,
                                shu_channels=4)
    a["synthesis"]["args"].update(ch_base=2048, ch_max=16, w_dim=16,
                                  w0_dim=16)
    return m


@pytest.fixture(scope="module")
def pool():
    return inputs.pool(SEED, 2, RES)


def _engine(model, **kw):
    """An engine with the benchmark's seeded weights, as its serving cells
    build it."""
    e = InpaintEngine(model, seed=SEED, device="cpu", batch_size=2, **kw)
    sd = e.G.state_dict()
    tmpl = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in sd.items()}
    weights = inputs.weights(tmpl, model, SEED, "cpu")
    for G in e.replicas.values():
        G.load_state_dict(weights, strict=True)
    return e, weights


@pytest.fixture
def k3_calls(monkeypatch):
    """Counts the calls of K3's plain version; each also counts as a K3
    launch, as the kernel's wrapper does on the card."""
    calls = []
    plain = conv1024.conv3x3_lowch_plain

    def counted(x, w, halo=0):
        calls.append(tuple(x.shape))
        build.count("conv3x3_lowch")
        return plain(x, w, halo)

    monkeypatch.setattr(conv1024, "conv3x3_lowch_plain", counted)
    build.reset_launches()
    yield calls
    build.reset_launches()


def test_tiny_g1024_engine_matches_the_plain_reference(model, pool,
                                                       k3_calls):
    """The engine, on K3's route, against the reference's composite on
    the same seeded weights, z and noise, within the tolerances of the
    benchmark's tiny-reference test: no kept pixel changed (the composite
    copies them from the input) and no hole pixel more than one level
    from the reference's float composite rounded down (float32 sums in
    another order can carry a value across a uint8 boundary, no further)."""
    images, masks = pool
    e, P = _engine(model)
    start = 1 << 20
    got = e.inpaint(images, masks, start_index=start)
    assert k3_calls == [(2, 2, RES, RES)] * 2
    want = ref.composite(P, model, torch.from_numpy(images),
                         torch.from_numpy(masks), SEED, start,
                         ref.constants(model, "cpu")).numpy()
    kept = np.broadcast_to(masks.astype(bool), got.shape)
    assert np.array_equal(got[kept], images[kept])
    gap = got.astype(np.float64) - np.floor(want)
    assert np.abs(gap[~kept]).max() <= 1


@pytest.mark.parametrize("outer", [torch.enable_grad, torch.no_grad])
def test_the_route_is_the_engines_own(model, pool, k3_calls, outer):
    """Whatever the caller's grad mode, the engine runs K3: its two convs
    a batch, in ``inpaint``, ``inpaint_stream`` and over two devices."""
    images, masks = pool
    with outer():
        e, _ = _engine(model)
        e.inpaint(images, masks)
        list(e.inpaint_stream([(images, masks)] * 2))
        assert k3_calls == [(2, 2, RES, RES)] * 6
        k3_calls.clear()
        mesh, _ = _engine(model, mesh=["cpu", "cpu"])
        mesh.inpaint(images, masks)
        assert k3_calls == [(1, 2, RES, RES)] * 4   # two blocks of one row


class _FakeGraph:
    def replay(self):
        pass


@pytest.mark.parametrize("batches", [1, 3])
def test_replay_adds_the_graphs_k3_launches(model, pool, k3_calls,
                                            monkeypatch, batches):
    """With the device parts of a capture stubbed, the capture counts K3's
    two launches, and each replay adds them to the counts once: 2 a
    batch, as ``kernels/build.launches`` reads on the card."""
    images, masks = pool
    e, _ = _engine(model)
    cf = e.compiled
    cf.captures = True
    monkeypatch.setattr(cf, "_warm_up", lambda st: None)
    monkeypatch.setattr(cf, "_record",
                        lambda st: (_FakeGraph(), cf._forward(st)))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    list(e.inpaint_stream([(images, masks)] * batches))
    assert len(k3_calls) == 2          # the capture's forward alone
    assert build.launches["conv3x3_lowch"] == 2 * batches
