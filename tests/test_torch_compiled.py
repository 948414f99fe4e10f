"""The compiled forward (``shgan_torch/runtime/compiled.py``) and the noise
table it writes, on the CPU at a tiny size: the table's rows, the fused
epilogue's plain version keyed by a table row against the integer key, the
compiled forward's CPU path (statics and table, nothing captured) against
``composite_forward`` and the port's engine against the JAX engine, the
launch accounting of a replay (the device parts stubbed), and the path each
engine takes.  The capture itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``compiled_path``)."""

import numpy as np
import pytest
import torch

from test_torch_models import (RES, _inputs, _nonzero_noise_and_bias,
                               tiny_cfg)

from shgan_tpu.checkpoint import (params_to_flat_state_dict,
                                  torch_state_dict_to_params)
from shgan_tpu.parallel import create_mesh
from shgan_tpu.serve import InpaintEngine as JaxEngine
from shgan_torch.checkpoint import params_from_jax
from shgan_torch.data.rng import derive_seed
from shgan_torch.kernels import build
from shgan_torch.models import get_model
from shgan_torch.models.infer import composite_forward, z_for_positions
from shgan_torch.ops import noise
from shgan_torch.ops import noise_bias_act as nba
from shgan_torch.ops.bias_act import parse_activation
from shgan_torch.runtime import compiled as cmod
from shgan_torch.serve import BATCH_NOISE_SALT, InpaintEngine


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(seed=3, strength=0.3):
    G = get_model(tiny_cfg(), seed=seed).eval().requires_grad_(False)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(strength)
    return G


def test_noise_table_rows_are_the_layer_keys():
    ids = [8, 17, 16, 9]
    t = noise.noise_table(21, ids, row0=5)
    assert t.dtype == torch.int64 and tuple(t.shape) == (18, 3)
    for i in range(18):
        want = (*noise.noise_key(21, i), 5) if i in ids else (0, 0, 0)
        assert tuple(t[i].tolist()) == want
    out = torch.full((18, 3), -1, dtype=torch.int64)
    assert noise.noise_table(21, ids, 5, out=out) is out
    assert torch.equal(out, t)
    with pytest.raises(ValueError, match="32-bit"):
        noise.noise_table(21, ids, row0=2 ** 32)
    with pytest.raises(ValueError, match="int64"):
        noise.noise_table(21, ids, out=torch.zeros((17, 3),
                                                   dtype=torch.int64))


def test_model_noise_layer_ids():
    G = _model()
    ids = cmod.noise_layer_ids(G)
    # b4's conv is 8, a block at r has 2r and 2r + 1
    assert ids == [8, 16, 17, 32, 33, 64, 65]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row0,h0,rows", [(0, None, None), (5, None, None),
                                          (3, 4, 8), (7, 12, 4)])
def test_epilogue_table_row_equals_integer_key(dtype, row0, h0, rows):
    """The plain versions of the epilogue, its grad and its mask mode keyed
    by a table row give the bits of the integer key and ``row0``: whole
    planes and a window of plane rows."""
    n, c, res = 3, 4, 16
    g = torch.Generator().manual_seed(row0 + (h0 or 0))
    x = (torch.randn(n, c, rows or res, res, generator=g) * 3).to(dtype)
    dy = torch.randn(x.shape, generator=g).to(dtype)
    d = torch.rand(n, c, generator=g) + 0.5
    b = torch.randn(c, generator=g) * 0.3
    s = torch.tensor(0.3)
    act = nba.epilogue_act(parse_activation(
        "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"), 0.7)
    layer = 2 * res + 1
    table = noise.noise_table(11, [2 * res, layer], row0)
    key = noise.noise_key(11, layer)
    kw = dict(dcoefs=d, bias=b, act=act, noise_mode="random", strength=s,
              h0=h0)
    by_int = dict(kw, noise_key=key, row0=row0)
    by_row = dict(kw, noise_key=table[layer])
    want = nba.noise_bias_act_plain(x, **by_int)
    got = nba.noise_bias_act_plain(x, **by_row)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    assert torch.equal(nba.noise_bias_act(x.clone(), **by_row), want)
    for a, w in zip(nba.noise_bias_act_grad_plain(dy, x, **by_row),
                    nba.noise_bias_act_grad_plain(dy, x, **by_int)):
        assert torch.equal(a, w)
    assert torch.equal(nba.noise_bias_act_mask_plain(dy, x, vs=s, **by_row),
                       nba.noise_bias_act_mask_plain(dy, x, vs=s, **by_int))
    # another row0 in the table draws other noise
    other = noise.noise_table(11, [layer], row0 + 1)[layer]
    assert not torch.equal(nba.noise_bias_act_plain(
        x, **dict(kw, noise_key=other)), want)


def test_epilogue_table_row_refuses_a_second_row0():
    x = torch.zeros(1, 2, 8, 8)
    row = noise.noise_table(1, [16], 4)[16]
    with pytest.raises(ValueError, match="row0 = 0"):
        nba.noise_bias_act_plain(x, noise_mode="random", noise_key=row,
                                 strength=torch.tensor(1.0), row0=2)
    with pytest.raises(ValueError, match="int64"):
        nba.noise_bias_act_plain(x, noise_mode="random",
                                 noise_key=row.int(),
                                 strength=torch.tensor(1.0))


def test_layer_reads_its_table_row():
    """A synthesis layer keyed by the table equals the layer keyed by the
    integer seed and row0."""
    G = _model()
    layer = G.synthesis.b16.conv1
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, layer.weight.shape[1], 16, 16, generator=g)
    w = torch.randn(2, layer.affine.weight.shape[1], generator=g)
    table = noise.noise_table(9, cmod.noise_layer_ids(G), 6)
    with torch.no_grad():
        want = layer(x, w, noise_seed=9, row0=6)
        got = layer(x, w, noise_seed=table)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="row0 = 0"):
        layer(x, w, noise_seed=table, row0=6)


@pytest.mark.parametrize("noise_mode", ["random", "const"])
@pytest.mark.parametrize("u8", [True, False])
def test_compiled_cpu_path_equals_composite_forward(noise_mode, u8):
    """The CPU path writes the inputs and the batch's table into its
    statics and runs composite_forward on them: the composite of the
    integer seed at row0, bit for bit; a key per input dtype."""
    G = _model()
    cf = cmod.CompiledForward(G, noise_mode)
    imgs, masks = _inputs(3, seed=4)
    real = imgs if u8 else imgs.astype(np.float32) / 127.5 - 1.0
    mask = masks[:, None]
    z = z_for_positions(7, G.z_dim, range(3))
    for seed, row0 in ((5, 0), (6, 3)):
        got = cf(real, mask, z, seed, row0=row0)
        with torch.inference_mode():
            want = composite_forward(
                G, torch.from_numpy(real), torch.from_numpy(mask),
                torch.from_numpy(z), noise_mode=noise_mode, noise_seed=seed,
                row0=row0)
        assert got.dtype == torch.uint8 and torch.equal(got, want)
    (key, st), = cf.statics.items()
    assert key[:5] == (3, RES, RES, torch.uint8 if u8 else torch.float32,
                       torch.float32)
    # another math flag is another key: a graph keeps the flags it had
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not prev
    try:
        assert cf.key(torch.from_numpy(real), torch.from_numpy(mask)) != key
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.equal(st.dev["real"], torch.from_numpy(real))
    assert torch.equal(st.dev["z"], torch.from_numpy(z))
    if noise_mode == "random":
        assert torch.equal(st.dev["table"], noise.noise_table(
            6, cf.layer_ids, 3))
    else:
        assert "table" not in st.dev
    assert not cf.records and cf.statics[key].graph is None


def test_compiled_cpu_path_refuses_another_shape():
    cf = cmod.CompiledForward(_model(), "none")
    imgs, masks = _inputs(2)
    z = np.zeros((2, 32), np.float32)
    cf(imgs, masks[:, None], z)
    with pytest.raises(ValueError, match="z is"):
        cf(imgs, masks[:, None], np.zeros((2, 32), np.float64))


def test_engine_through_the_compiled_module_matches_jax_engine():
    """The port's one-device engine runs each batch through the compiled
    forward's statics; on the same weights it still meets the JAX engine
    within 1 (noise const), a ragged tail through its bucket."""
    cfg = tiny_cfg()
    je = JaxEngine(cfg, batch_size=4, mesh=create_mesh(1), seed=7,
                   noise_mode="const", latency_batches=(2,))
    flat = _nonzero_noise_and_bias(params_to_flat_state_dict(je.params), 5)
    je.params = torch_state_dict_to_params(flat)
    te = InpaintEngine(cfg, batch_size=4, seed=7, noise_mode="const",
                       device="cpu", latency_batches=(2,))
    te.G.load_state_dict(params_from_jax(flat), strict=True)
    imgs, masks = _inputs(6, seed=3)
    want = je.inpaint(imgs, masks).astype(int)
    got = te.inpaint(imgs, masks).astype(int)
    assert got.shape == want.shape == (6, 3, RES, RES)
    assert np.abs(got - want).max() <= 1
    assert sorted(k[0] for k in te.compiled.statics) == [2, 4]


def test_engine_random_noise_equals_the_integer_seed():
    """The engine's batch seed goes into the table: each chunk's composite
    is composite_forward at the integer seed of its start."""
    e = InpaintEngine(tiny_cfg(), batch_size=2, seed=7, device="cpu")
    with torch.no_grad():
        for name, p in e.G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    imgs, masks = _inputs(4, seed=5)
    got = e.inpaint(imgs, masks, start_index=10)
    for lo in (0, 2):
        z = z_for_positions(7, e.G.z_dim, range(10 + lo, 12 + lo))
        with torch.inference_mode():
            want = composite_forward(
                e.G, torch.from_numpy(imgs[lo:lo + 2]),
                torch.from_numpy(masks[lo:lo + 2, None]),
                torch.from_numpy(z), noise_seed=derive_seed(
                    7, 10 + lo, BATCH_NOISE_SALT))
        np.testing.assert_array_equal(got[lo:lo + 2], want.numpy())
    assert not np.array_equal(got[:2], e.inpaint(imgs[:2], masks[:2],
                                                 start_index=11))


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_captured_launches_once_per_call(monkeypatch):
    """The capture's accounting with the device parts stubbed: the warm-up
    and the capture count nothing, each replay adds the launches the
    capture recorded."""
    G = _model()
    cf = cmod.CompiledForward(G, "random")
    cf.captures = True
    forwards = []

    def fake_forward(st):
        forwards.append(st)
        build.count("noise_bias_act")
        build.count("noise_bias_act")
        build.count("upfirdn2d")
        return torch.zeros(1, dtype=torch.uint8)

    graphs = []

    def fake_record(st):
        graphs.append(_FakeGraph())
        return graphs[-1], cf._forward(st)

    def fake_warm_up(st):
        for _ in range(cmod.WARMUP):
            cf._forward(st)

    monkeypatch.setattr(cf, "_forward", fake_forward)
    monkeypatch.setattr(cf, "_warm_up", fake_warm_up)
    monkeypatch.setattr(cf, "_record", fake_record)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    build.reset_launches()
    imgs, masks = _inputs(2)
    z = np.zeros((2, 32), np.float32)
    for i in range(3):
        cf(imgs, masks[:, None], z, noise_seed=i)
    # warm-up (2) and capture (1) ran the forward; the replays did not
    assert len(forwards) == cmod.WARMUP + 1 and len(graphs) == 1
    assert graphs[0].replays == 3
    assert build.snapshot() == dict(build.launches, noise_bias_act=6,
                                    upfirdn2d=3)
    (rec,) = cf.records
    assert rec["launches_per_replay"] == {"noise_bias_act": 2,
                                          "upfirdn2d": 1}
    # another shape captures once more
    cf(imgs[:1], masks[:1, None], z[:1], noise_seed=0)
    assert len(graphs) == 2 and build.launches["noise_bias_act"] == 8
    build.add({"upfirdn2d": -3})
    assert build.launches["upfirdn2d"] == 1
    build.reset_launches()


def test_a_failed_capture_raises_and_counts_nothing(monkeypatch):
    """A capture that fails raises (no eager fallback), leaves the counts
    as they were and no graph behind: the next call captures again."""
    cf = cmod.CompiledForward(_model(), "none")
    cf.captures = True

    def warm_up(st):
        build.count("upfirdn2d")

    def record(st):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(cf, "_warm_up", warm_up)
    monkeypatch.setattr(cf, "_record", record)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    build.reset_launches()
    imgs, masks = _inputs(2)
    z = np.zeros((2, 32), np.float32)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture refused"):
            cf(imgs, masks[:, None], z)
        assert not cf.statics and not cf.records
        assert not any(build.launches.values())


def test_engines_report_their_path(monkeypatch):
    """A one-device CUDA engine is compiled; over several devices, on the
    CPU, and for the pluralistic synthesis it is eager (no card: the
    modules stay on the CPU)."""
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    cfg = tiny_cfg()
    one = InpaintEngine(cfg, batch_size=2, device="cuda:0")
    assert one.path() == "compiled" and one.compiled is not None
    two = InpaintEngine(cfg, batch_size=2, mesh=["cuda:0", "cuda:1"])
    assert two.path().startswith("eager: several devices")
    assert two.compiled is None
    cpu = InpaintEngine(cfg, batch_size=2, device="cpu")
    assert cpu.path() == "eager: on the CPU, nothing to capture"
    plur = dict(cfg, args=dict(cfg["args"], synthesis=dict(
        cfg["args"]["synthesis"], type="comodgan_synthesis_plur")))
    p = InpaintEngine(plur, batch_size=2, device="cuda:0")
    assert p.path() == "eager: the pluralistic synthesis draws w0 on the host"
    G = one.G
    assert cmod.eager_reason(G, ["cuda:0"], ranks=2).startswith(
        "several ranks")
    assert cmod.eager_reason(G, ["cuda:0"]) is None
