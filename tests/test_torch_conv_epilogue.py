"""A conv layer's bias and activation as one epilogue call
(``models/layers.Conv2dLayer`` through ``ops/noise_bias_act``, the
``bias_lrelu`` launch on the card) on the CPU, held to the chain the layer
ran before: ``add_bias``, then the activation's function.  The forward bit
for bit, the first and second order against autograd of the chain,
other activations refused, and a tiny encoder's features unchanged."""

import numpy as np
import pytest
import torch

from shgan_torch.models import get_model
from shgan_torch.models import layers as layers_mod
from shgan_torch.models.layers import Conv2dLayer
from shgan_torch.ops import noise_bias_act as nba
from shgan_torch.ops.bias_act import add_bias, get_activation
from shgan_torch.ops.conv_resample import conv2d_resample
from test_torch_models import tiny_cfg

LRELU = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
HALF = float(np.sqrt(0.5))
# (activation, bias, runtime gain): the encoder's convs, D's conv1, a
# linear layer with a gain, no bias, and neither (D's skip: x * gain)
CASES = {"lrelu_clamp": (LRELU, True, 1.0), "lrelu_gain": (LRELU, True, HALF),
         "linear_gain": (None, True, HALF), "no_bias": (LRELU, False, 1.0),
         "neither": (None, False, HALF)}


def _layer(spec, bias, down, c_in=3, c_out=5, k=3, seed=0):
    layer = Conv2dLayer(c_in, c_out, k, bias=bias, activation=spec,
                        down=down, generator=torch.Generator().manual_seed(
                            seed))
    if bias:
        with torch.no_grad():
            layer.bias.copy_(torch.randn(c_out, generator=torch.Generator()
                                         .manual_seed(seed + 1)) * 0.5)
    return layer


def _chain_forward(layer, spec, x, gain=1.0, slab=None, src=None):
    """Conv2dLayer.forward as it ran before: the conv, ``add_bias``, then
    the activation's function (or the gain)."""
    w = layer.weight * layer.weight_gain
    x = conv2d_resample(x, w.to(x.dtype), f=layer.resample_filter,
                        up=layer.up, down=layer.down, padding=layer.padding,
                        flip_weight=(layer.up == 1), slab=slab, src=src)
    if layer.bias is not None:
        x = add_bias(x, layer.bias, slab)
    act = get_activation(spec)
    if act is not None:
        return act(x, gain=gain)
    return x * gain if gain != 1.0 else x


def _input(res, c=3, seed=2, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, c, res, res, generator=g) * 60).to(dtype)


def _calls(monkeypatch):
    """The epilogue calls of the layers module, by the kernel each would
    launch on the card."""
    seen = []
    real = layers_mod.noise_bias_act

    def counted(x, dcoefs=None, *a, **k):
        seen.append(nba.kernel_of(dcoefs, k.get("noise_mode", "none")))
        return real(x, dcoefs, *a, **k)
    monkeypatch.setattr(layers_mod, "noise_bias_act", counted)
    return seen


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("down", [1, 2])
@pytest.mark.parametrize("res", [4, 8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_equals_the_chain_bit_for_bit(res, down, case, dtype,
                                             monkeypatch):
    """Each layer's output is the chain's, bit for bit, through one
    bias_lrelu epilogue call (none for a layer with neither a bias nor an
    activation)."""
    spec, bias, gain = CASES[case]
    layer = _layer(spec, bias, down).requires_grad_(False)
    x = _input(res, dtype=dtype)
    seen = _calls(monkeypatch)
    got = layer(x, gain=gain)
    want = _chain_forward(layer, spec, x, gain)
    assert got.dtype == dtype and torch.equal(got, want)
    assert seen == ([] if case == "neither" else ["bias_lrelu"])


def _grads(layer, spec, x, gain, fused):
    """First order of a weighted sum through tanh, and the double backward
    of an R1-shaped penalty on the input's gradient, for the input and the
    layer's parameters."""
    params = [p for p in layer.parameters()]
    xr = x.clone().requires_grad_(True)
    y = layer(xr, gain=gain) if fused else _chain_forward(layer, spec, xr,
                                                          gain)
    u = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
    s = (torch.tanh(y / 50) * u).sum()
    first = torch.autograd.grad(s, [xr] + params, create_graph=True)
    pen = first[0].square().sum()
    second = torch.autograd.grad(pen, [xr] + params)
    return [t.detach() for t in first] + list(second)


@pytest.mark.parametrize("case", ["lrelu_clamp", "lrelu_gain",
                                  "linear_gain", "no_bias"])
@pytest.mark.parametrize("down", [1, 2])
def test_gradients_equal_autograd_of_the_chain(down, case):
    """The epilogue's backward (the grad kernel's plain version) and its
    double backward (the mask-only mode) against autograd of the chain:
    d/dx and d/dparams of the sum, and of the penalty on d/dx."""
    spec, bias, gain = CASES[case]
    layer = _layer(spec, bias, down)
    x = _input(16)
    got = _grads(layer, spec, x, gain, True)
    want = _grads(layer, spec, x, gain, False)
    assert len(got) == len(want) == 2 * (2 + bias)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("spec", ["relu", "sine(freq=30.0)"])
def test_relu_and_sine_layers_are_refused(spec):
    """Activations the epilogue does not take are refused when the layer is
    built, as SynthesisLayer refuses them."""
    with pytest.raises(ValueError, match="lrelu_agc or a linear"):
        _layer(spec, True, 1)


@pytest.mark.parametrize("fp16_res", [None, 8])
def test_encoder_features_are_unchanged(fp16_res, monkeypatch):
    """A tiny shgan_encoder (float32, or bf16 above 8²): its global code
    and every skip feature equal those of the same encoder with each
    Conv2dLayer on the chain, bit for bit; one bias_lrelu call a conv."""
    cfg = tiny_cfg(32)
    cfg["args"]["encoder"]["args"]["use_fp16_before_res"] = fp16_res
    enc = get_model(cfg, seed=3).encoder.requires_grad_(False)
    n_convs = sum(type(m).__name__ == "Conv2dLayer" for m in enc.modules())
    g = torch.Generator().manual_seed(4)
    img = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    mask = (torch.rand(2, 1, 32, 32, generator=g) > 0.5).float()
    x_in = torch.cat([mask - 0.5, img * mask], dim=1)
    seen = _calls(monkeypatch)
    got = enc(x_in)
    assert seen == ["bias_lrelu"] * n_convs
    specs = {id(m): "lrelu_agc(%s)" % ", ".join(
        f"{k}={v}" for k, v in m.activation[1].items())
        for m in enc.modules() if type(m).__name__ == "Conv2dLayer"}
    monkeypatch.setattr(Conv2dLayer, "forward",
                        lambda self, x, gain=1.0, slab=None, src=None:
                        _chain_forward(self, specs[id(self)], x, gain, slab,
                                       src))
    want = enc(x_in)
    assert torch.equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1]) and len(got[1]) > 0
    for r, b in want[1].items():
        assert got[1][r].dtype == b.dtype and torch.equal(got[1][r], b)


def test_kernel_of_names_the_launch():
    """A launch with no dcoefs and no noise is bias_lrelu; any other the
    fused epilogue; the launch counts have both keys."""
    from shgan_torch.kernels import build
    assert nba.kernel_of(None, "none") == "bias_lrelu"
    assert nba.kernel_of(torch.ones(1, 1), "none") == "noise_bias_act"
    assert nba.kernel_of(None, "random") == "noise_bias_act"
    assert nba.kernel_of(None, "const") == "noise_bias_act"
    assert {"bias_lrelu", "noise_bias_act"} <= set(build.launches)
