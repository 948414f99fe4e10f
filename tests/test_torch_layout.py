"""Channels-last activations on the CPU (``shgan_torch/ops/layout.py``): the
kernel wrappers' plain versions on channels-last tensors against NCHW (the
same values, the input's layout kept), the backward wrappers' refusal of a
channels-last tensor that records a gradient, the composite forward in
channels-last (the same composite, NCHW-contiguous uint8 out, every conv
and kernel of the generator reached channels-last), the compiled forward's
CPU path and the launch counter's NHWC split.  The kernels' NHWC index maps
themselves are held to their NCHW maps by ``tests/test_torch_kernel_math.py``
and, on the card, by ``tests/test_torch_cuda.py``."""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_models import tiny_cfg

from shgan_torch.kernels import build
from shgan_torch.models import get_model
from shgan_torch.models.infer import composite_forward
from shgan_torch.ops import conv1024
from shgan_torch.ops.bias_act import parse_activation
from shgan_torch.ops.layout import CL, channels_last, like, scaled_weight
from shgan_torch.ops.noise import noise_key
from shgan_torch.runtime.compiled import CompiledForward

fir = importlib.import_module("shgan_torch.ops.upfirdn2d")
nba = importlib.import_module("shgan_torch.ops.noise_bias_act")

ACT = nba.epilogue_act(
    parse_activation("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"))


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cl(x):
    return x.contiguous(memory_format=CL)


def _same(a, b):
    """Equal values, NaN where NaN, bit for bit."""
    return torch.equal(a.contiguous().view(torch.int32)
                       if a.dtype == torch.float32 else a.contiguous(),
                       b.contiguous().view(torch.int32)
                       if b.dtype == torch.float32 else b.contiguous())


def test_layout_predicates():
    x = torch.randn(2, 5, 4, 6)
    assert not channels_last(x) and channels_last(_cl(x))
    # one channel, or 1 x 1 planes: the layouts coincide, NCHW is taken
    assert not channels_last(_cl(torch.randn(2, 1, 4, 6)))
    assert not channels_last(_cl(torch.randn(2, 5, 1, 1)))
    assert not channels_last(_cl(x)[:, 1:])          # not dense
    # like() follows a channels-last tensor and a slice of its channels
    y = torch.randn(2, 3, 4, 6)
    assert like(y, x) is y
    assert channels_last(like(y, _cl(x))) and channels_last(
        like(y, _cl(x)[:, 2:]))
    assert torch.equal(like(y, _cl(x)), y)


def test_scaled_weight_takes_the_conv_inputs_layout():
    """A conv layer's scaled weight: the product w * gain, written
    channels-last where the conv input is and no gradient is recorded (the
    layout cuDNN reads it in), else as before."""
    w = torch.randn(8, 4, 3, 3)
    x = torch.randn(2, 4, 5, 5)
    got = scaled_weight(w, 0.3, _cl(x))
    assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    assert torch.equal(got, w * 0.3)
    assert scaled_weight(w, 0.3, x).is_contiguous()
    wg = w.clone().requires_grad_(True)
    assert scaled_weight(wg, 0.3, _cl(x)).is_contiguous()   # training
    with torch.no_grad():
        assert not scaled_weight(wg, 0.3, _cl(x)).is_contiguous()


def test_scaled_weight_of_a_transposed_conv():
    """A transposed conv's kernel: the product written so that its OI swap
    (``conv_resample._transpose_weight`` without the flips, which cancel
    for a convolution kernel) is channels-last, the layout cuDNN reads a
    channels-last transposed conv's weight in; the same values."""
    from shgan_torch.ops.conv_resample import _transpose_weight
    w = torch.randn(8, 4, 3, 3)
    x = _cl(torch.randn(2, 4, 5, 5))
    with torch.no_grad():
        got = scaled_weight(w, 0.3, x, transposed=True)
    assert torch.equal(got, w * 0.3)
    t = _transpose_weight(got, 1, flip=False)
    assert t.shape == (4, 8, 3, 3) and t.is_contiguous(memory_format=CL)
    assert scaled_weight(w, 0.3, x.contiguous(), transposed=True) \
        .is_contiguous()


@pytest.mark.parametrize("groups", [1, 2])
def test_transpose_weight_flips_cancel(groups):
    """The up path's weight: flipping a convolution kernel and then the
    transposed conv's flip give the OI swap alone, bit for bit."""
    from shgan_torch.ops.conv_resample import _maybe_flip, _transpose_weight
    w = torch.randn(8, 4 // groups, 3, 3)
    assert torch.equal(_transpose_weight(_maybe_flip(w, False), groups),
                       _transpose_weight(w, groups, flip=False))
    assert torch.equal(_transpose_weight(w, groups),
                       _transpose_weight(w, groups, flip=True))


@pytest.mark.parametrize("up", [1, 2])
def test_modulated_conv_weight_follows_the_layout(up):
    """A modulated conv on a channels-last input writes its normalized
    weight in the conv's layout: the same conv output, and the dcoefs of
    the NCHW weight bit for bit (the squares are summed in NCHW order)."""
    from shgan_torch.ops.modulated_conv import modulated_conv2d
    from shgan_torch.ops.upfirdn2d import setup_filter
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 6, 6, generator=g)
    w = torch.randn(16, 8, 3, 3, generator=g)
    s = torch.randn(2, 8, generator=g)
    kw = dict(up=up, padding=1, flip_weight=up == 1, split_dcoefs=True,
              resample_filter=setup_filter([1, 3, 3, 1]) if up > 1 else None)
    with torch.inference_mode():
        a, da = modulated_conv2d(x, w, s, **kw)
        b, db = modulated_conv2d(_cl(x), w, s, **kw)
    assert channels_last(b)
    assert torch.allclose(b, a, rtol=1e-5, atol=1e-5)
    assert torch.equal(db, da)


def test_channels_last_forward_hands_convs_channels_last_weights(monkeypatch):
    """In a channels-last inference forward every conv's weight reaches
    F.conv2d / F.conv_transpose2d already channels-last (so cuDNN copies
    none): the conv layers' scaled weights and the modulated convs'
    normalized weights, up convs included.  (The depthwise convs of K2's
    plain version, which the card does not run, are left out.)"""
    seen = []

    def probe(name):
        f = getattr(F, name)

        def g(x, w, *a, **k):
            if k.get("groups", 1) == 1:
                seen.append((name, tuple(w.shape),
                             w.is_contiguous(memory_format=CL)))
            return f(x, w, *a, **k)
        monkeypatch.setattr(F, name, g)

    for name in ("conv2d", "conv_transpose2d"):
        probe(name)
    G = _generator()
    real, mask, z = _batch()
    with torch.inference_mode():
        composite_forward(G, real, mask, z, noise_seed=3, memory_format=CL)
    assert {n for n, _, _ in seen} == {"conv2d", "conv_transpose2d"}
    assert [s for s in seen if not s[2]] == []


FIR_CALLS = [
    # (up, down, pads, taps shape): the main path's three call sites, then
    # down = 2, signed pads, other taps
    ((1, 1), (1, 1), (2, 2, 2, 2), (4, 4)),
    ((1, 1), (1, 1), (1, 1, 1, 1), (4, 4)),
    ((2, 2), (1, 1), (2, 1, 2, 1), (4, 4)),
    ((1, 1), (2, 2), (1, 1, 1, 1), (4, 4)),
    ((1, 1), (1, 1), (-1, 2, 0, -2), (3, 5)),
    ((2, 1), (1, 2), (1, 1, 2, 2), (8, 8)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 8])
@pytest.mark.parametrize("up,down,pads,shape", FIR_CALLS)
def test_fir_plain_keeps_the_layout(up, down, pads, shape, c, dtype):
    g = torch.Generator().manual_seed(c)
    x = torch.randn(2, c, 9, 10, generator=g).to(dtype)
    taps = torch.randn(shape, generator=g).numpy()
    want = fir.fir(x, taps, up, down, pads)
    got = fir.fir(_cl(x), taps, up, down, pads)
    assert channels_last(got) and want.is_contiguous()
    assert _same(got, want)
    # through upfirdn2d, which no longer makes its input NCHW
    f = fir.setup_filter([1, 3, 3, 1])
    u = fir.upfirdn2d(_cl(x), f, up=up, down=down, padding=list(pads))
    assert channels_last(u)
    assert _same(u, fir.upfirdn2d(x, f, up=up, down=down,
                                  padding=list(pads)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["random", "const", "none"])
@pytest.mark.parametrize("demod,with_bias", [(True, True), (False, True),
                                             (False, False)])
def test_epilogue_plain_keeps_the_layout(demod, with_bias, mode, dtype):
    g = torch.Generator().manual_seed(7)
    n, c, r = 2, 6, 8
    x = (torch.randn(n, c, r, r, generator=g) * 3).to(dtype)
    kw = dict(dcoefs=torch.rand(n, c, generator=g) + 0.5 if demod else None,
              bias=torch.randn(c, generator=g) if with_bias else None,
              act=ACT, noise_mode=mode, noise_key=noise_key(5, 16),
              noise_const=torch.randn(r, r, generator=g),
              strength=torch.tensor(0.3), row0=3)
    want = nba.noise_bias_act(x.clone(), **kw)
    got = nba.noise_bias_act(_cl(x), **kw)
    assert channels_last(got) and want.is_contiguous()
    assert _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_plain_keeps_the_layout(dtype):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 6, 10, 12, generator=g).to(dtype)
    w = torch.randn(5, 6, 3, 3, generator=g)
    got = conv1024.conv3x3_lowch(_cl(x), w)
    assert channels_last(got)
    assert _same(got, conv1024.conv3x3_lowch(x, w))


def test_k3_route_takes_the_layouts_it_stages():
    """The route does not look at the layout: an eligible conv goes to K3
    in either (the kernel's wrapper refuses the one case it does not stage,
    channels-last bfloat16 with an odd C, which nothing serves)."""
    w = torch.randn(32, 31, 3, 3)
    for dtype, c in ((torch.float32, 31), (torch.bfloat16, 32),
                     (torch.bfloat16, 31)):
        x = torch.empty((1, c, 1024, 1024), dtype=dtype, device="meta")
        ww = w[:, :c] if c == 31 else torch.randn(32, 32, 3, 3)
        assert conv1024.takes_k3(x, ww, 1, 1, (1, 1))
        assert conv1024.takes_k3(_cl(x), ww, 1, 1, (1, 1))


def test_backward_wrappers_refuse_channels_last_under_autograd():
    x = _cl(torch.randn(2, 4, 8, 8)).requires_grad_(True)
    taps = fir.correlation_taps(fir.setup_filter([1, 3, 3, 1]))
    with pytest.raises(ValueError, match="NCHW"):
        fir.fir(x, taps, (1, 1), (1, 1), (1, 1, 1, 1))
    b = torch.zeros(4, requires_grad=True)
    with pytest.raises(ValueError, match="NCHW"):
        nba.noise_bias_act(x, None, b, ACT)
    with pytest.raises(ValueError, match="NCHW"):
        nba.noise_bias_act(_cl(torch.randn(2, 4, 8, 8)), None, b, ACT)
    # NCHW under autograd, and channels-last with no gradient, still run
    y = fir.fir(x.detach().contiguous().requires_grad_(True), taps, (1, 1),
                (1, 1), (1, 1, 1, 1))
    y.sum().backward()
    with torch.no_grad():
        assert channels_last(nba.noise_bias_act(x.detach(), None, b, ACT))


def _generator(seed=1):
    cfg = tiny_cfg()
    # the served encoders end in the minibatch stddev
    cfg["args"]["encoder"]["args"].update(mbstd_group_size=4, mbstd_c_n=1)
    G = get_model(cfg, seed=seed).eval().requires_grad_(False)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength") or name.endswith("bias"):
                p.uniform_(-0.3, 0.3)
    return G


def _batch(n=4, res=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    real = torch.randint(0, 256, (n, 3, res, res), generator=g,
                         dtype=torch.uint8)
    mask = (torch.rand(n, 1, res, res, generator=g) > 0.4).to(torch.uint8)
    return real, mask, torch.randn(n, 32, generator=g)


@pytest.mark.parametrize("inputs_cl", [False, True])
@pytest.mark.parametrize("mode", ["random", "const", "none"])
def test_channels_last_composite_equals_nchw(mode, inputs_cl):
    """The channels-last forward gives the NCHW forward's composite bit for
    bit on the CPU, and its uint8 output is NCHW-contiguous whatever the
    layout of the activations or of the inputs."""
    G = _generator()
    real, mask, z = _batch()
    kw = dict(noise_mode=mode, noise_seed=11 if mode == "random" else None)
    with torch.inference_mode():
        want = composite_forward(G, real, mask, z, **kw)
        r, m = (_cl(real), _cl(mask)) if inputs_cl else (real, mask)
        got = composite_forward(G, r, m, z, memory_format=CL, **kw)
        nchw_in = composite_forward(G, r, m, z, **kw)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert want.is_contiguous() and nchw_in.is_contiguous()
    assert torch.equal(got, want) and torch.equal(nchw_in, want)


def test_channels_last_reaches_every_conv_and_kernel(monkeypatch):
    """Propagation: in a channels-last forward every convolution and every
    kernel wrapper's plain version (K2, the epilogue, bias_lrelu) receives a
    channels-last tensor, so none of them moves the layout: the network
    input is the one place it is chosen."""
    seen = []
    depth = [0]

    def probe(mod, name):
        f = getattr(mod, name)

        def g(x, *a, **k):
            if depth[0] == 0:
                seen.append((name, tuple(x.shape), channels_last(x)))
            depth[0] += 1
            try:
                return f(x, *a, **k)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(mod, name, g)

    for mod, name in ((F, "conv2d"), (F, "conv_transpose2d"),
                      (fir, "fir_plain"), (nba, "noise_bias_act_plain")):
        probe(mod, name)
    G = _generator()
    real, mask, z = _batch()
    with torch.inference_mode():
        composite_forward(G, real, mask, z, noise_seed=3, memory_format=CL)
    names = {n for n, _, _ in seen}
    assert names == {"conv2d", "conv_transpose2d", "fir_plain",
                     "noise_bias_act_plain"}
    assert [s for s in seen if not s[2]] == []


def test_compiled_cpu_path_runs_nchw(monkeypatch):
    """On the CPU the compiled forward runs its statics eagerly in NCHW and
    gives composite_forward's bits; the channels-last layout is the CUDA
    capture's alone."""
    G = _generator()
    real, mask, z = _batch()
    formats = []
    real_cf = composite_forward

    def spy(*a, memory_format=torch.contiguous_format, **k):
        formats.append(memory_format)
        return real_cf(*a, memory_format=memory_format, **k)

    monkeypatch.setattr("shgan_torch.runtime.compiled.composite_forward", spy)
    cf = CompiledForward(G, noise_mode="const")
    got = cf(real.numpy(), mask.numpy(), z.numpy())
    with torch.inference_mode():
        want = composite_forward(G, real, mask, z, noise_mode="const")
    assert formats == [torch.contiguous_format] and cf.last_path == "eager"
    assert got.is_contiguous() and torch.equal(got, want)


def test_launch_counter_splits_nhwc():
    before = build.snapshot(), build.snapshot_nhwc()
    try:
        build.reset_launches()
        build.count("upfirdn2d", True)
        build.count("upfirdn2d")
        build.count("bias_lrelu", True)
        build.count("noise_bias_act_grad")
        got, nhwc = build.snapshot(), build.snapshot_nhwc()
        assert got["upfirdn2d"] == 2 and nhwc["upfirdn2d"] == 1
        assert got["bias_lrelu"] == nhwc["bias_lrelu"] == 1
        assert got["noise_bias_act_grad"] == 1 and set(nhwc) == set(
            build.FORWARD_KERNELS)
        assert build.nhwc_share(got, nhwc) == pytest.approx(2 / 3)
        assert build.nhwc_share({}, {}) is None
        # a replay's counts, recorded at capture, carry the split
        build.add({"conv3x3_lowch": 2}, {"conv3x3_lowch": 2})
        assert build.snapshot_nhwc()["conv3x3_lowch"] == 2
        build.reset_launches()
        assert not any(build.snapshot_nhwc().values())
    finally:
        build.reset_launches()
        build.add(*before)


def test_replay_adds_the_nhwc_launches_recorded_at_capture(monkeypatch):
    """The capture's accounting with the device parts stubbed, its forward
    launching on the NHWC maps: each replay adds the NHWC launches beside
    the totals, and the warm-up and the capture count nothing."""
    cf = CompiledForward(_generator(), "none")
    cf.captures = True

    def fake_forward(st):
        build.count("upfirdn2d", True)
        build.count("bias_lrelu", True)
        build.count("noise_bias_act")
        return torch.zeros(1, dtype=torch.uint8)

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(cf, "_forward", fake_forward)
    monkeypatch.setattr(cf, "_warm_up", lambda st: [
        cf._forward(st) for _ in range(2)])
    monkeypatch.setattr(cf, "_record", lambda st: (Graph(), cf._forward(st)))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    before = build.snapshot(), build.snapshot_nhwc()
    try:
        build.reset_launches()
        real, mask, z = _batch(2)
        for _ in range(3):
            cf(real, mask, z)
        (rec,) = cf.records
        assert rec["nhwc_launches_per_replay"] == {"upfirdn2d": 1,
                                                   "bias_lrelu": 1}
        assert build.snapshot_nhwc() == dict(
            build.snapshot_nhwc(), upfirdn2d=3, bias_lrelu=3)
        assert build.nhwc_share(build.snapshot(),
                                build.snapshot_nhwc()) == pytest.approx(2 / 3)
    finally:
        build.reset_launches()
        build.add(*before)
