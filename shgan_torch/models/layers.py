"""Core StyleGAN2 layers as ``nn.Module``s (port of
``shgan_tpu/models/layers.py``).

Parameter names equal the JAX package's flat names (``affine.weight``,
``noise_strength``, ...), so a JAX parameter tree or a released ``.pth``
loads with ``load_state_dict(strict=True)`` after dropping the
``resample_filter`` buffers.  Parameters are drawn at construction from
the ``torch.Generator`` passed in (on the CPU, so the same seed gives the
same weights whatever device the model moves to).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import add_bias, get_activation, parse_activation
from ..ops.conv_resample import conv2d_resample
from ..ops.dense import dense_apply
from ..ops.layout import scaled_weight
from ..ops.modulated_conv import modulated_conv2d, normalize_styles
from ..ops.noise import noise_key
from ..ops.noise_bias_act import epilogue_act, noise_bias_act
from ..ops.upfirdn2d import setup_filter


def randn(shape, generator=None):
    """N(0, 1) float32 on the CPU from ``generator``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32)


def normalize_2nd_moment(x, dim=1, eps=1e-8):
    """x / sqrt(mean(x², dim) + eps)."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class Dense(nn.Module):
    """Equalized-LR fully-connected layer."""

    def __init__(self, in_features, out_features, bias=True, bias_init=0.0,
                 activation=None, lr_multi=1.0, generator=None):
        super().__init__()
        self.lr_multi = lr_multi
        self.activation = get_activation(activation)
        self.weight = nn.Parameter(
            randn((out_features, in_features), generator) / lr_multi)
        self.bias = (nn.Parameter(torch.full((out_features,), float(bias_init)))
                     if bias else None)

    def forward(self, x):
        return dense_apply(self.weight, self.bias, x, lr_multi=self.lr_multi,
                           activation=self.activation)


class Conv2d(nn.Module):
    """Plain conv2d with He init (the SHU's spectral 1×1 conv)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, use_wscale=False, generator=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        he_std = 1.0 / np.sqrt(in_channels * kernel_size * kernel_size)
        init_std, self.weight_gain = ((1.0, he_std) if use_wscale
                                      else (he_std, 1.0))
        k = kernel_size
        self.weight = nn.Parameter(
            randn((out_channels, in_channels, k, k), generator) * init_std)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def forward(self, x):
        w = self.weight
        if self.weight_gain != 1.0:
            w = w * self.weight_gain
        return F.conv2d(x, w.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        stride=self.stride, padding=self.padding)


class Conv2dLayer(nn.Module):
    """Equalized-LR conv with optional FIR up/downsampling.

    The bias and the activation (lrelu_agc or linear; any other is refused
    here, as in :class:`SynthesisLayer`) run after the conv as one
    :func:`noise_bias_act` call with no dcoefs and no noise: on the card one
    in-place launch of its ``bias_lrelu`` kernel (with grad mode on, a
    differentiable one whose backward is the grad kernel)."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True,
                 activation=None, up=1, down=1, resample_filter=(1, 3, 3, 1),
                 generator=None):
        super().__init__()
        self.in_channels = in_channels
        self.up = up
        self.down = down
        self.resample_filter = (setup_filter(resample_filter)
                                if resample_filter is not None else None)
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / np.sqrt(in_channels * kernel_size ** 2)
        self.activation = parse_activation(activation)
        epilogue_act(self.activation)   # lrelu_agc or linear, else raise
        k = kernel_size
        self.weight = nn.Parameter(
            randn((out_channels, in_channels, k, k), generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def forward(self, x, gain=1.0, slab=None, src=None):
        """``slab`` / ``src``: the output rows this rank computes and what
        ``x`` holds (:func:`~shgan_torch.ops.conv_resample.conv2d_resample`;
        None: the whole plane)."""
        w = scaled_weight(self.weight, self.weight_gain, x)
        x = conv2d_resample(x, w.to(x.dtype), f=self.resample_filter,
                            up=self.up, down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1), slab=slab, src=src)
        if self.bias is None and self.activation is None:
            return x * gain if gain != 1.0 else x
        return noise_bias_act(x, None, self.bias,
                              epilogue_act(self.activation, gain), slab=slab)


class SynthesisLayer(nn.Module):
    """Modulated conv + per-layer noise injection.

    ``layer_id`` keys this layer's random noise: with ``noise_mode='random'``
    the noise is K1's Philox stream of ``noise_key(noise_seed, layer_id)``,
    or, where ``noise_seed`` is a noise table (``ops/noise.noise_table``,
    in place of an integer seed and ``row0``), of the key and counter row
    in its row ``layer_id``.
    Everything after the conv (demodulation, noise, bias, activation) runs
    as one :func:`noise_bias_act` call: one kernel launch on the card, and
    with grad mode on, a differentiable one (its backward the grad kernel).
    ``noise_const`` is a buffer (the JAX step's ``_BUFFER_NAMES``): the
    optimizer leaves it alone and the EMA copies it.

    The no-grad route of ``models/synthesis.py`` hands a layer ``styles``
    (:meth:`input_scale`: its input already holds ``x ⊙ styles``) and its
    epilogue's fold (``addend``, ``scales``: its consumers' inputs, the
    tuple of them returned; ``ops/noise_bias_act``)."""

    def __init__(self, in_channels, out_channels, kernel_size, w_dim,
                 resolution, bias=True,
                 activation="lrelu_agc(alpha=0.2, gain=sqrt_2)", up=1,
                 resample_filter=(1, 3, 3, 1), use_noise=True, layer_id=0,
                 generator=None):
        super().__init__()
        self.resolution = resolution
        self.up = up
        self.use_noise = use_noise
        self.layer_id = layer_id
        self.resample_filter = (setup_filter(resample_filter)
                                if resample_filter is not None else None)
        self.padding = kernel_size // 2
        self.activation = parse_activation(activation)
        epilogue_act(self.activation)   # lrelu_agc or linear, else raise
        k = kernel_size
        self.weight = nn.Parameter(
            randn((out_channels, in_channels, k, k), generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)
        self.affine = Dense(w_dim, in_channels, bias=True, bias_init=1.0,
                            generator=generator)
        if use_noise:
            self.register_buffer("noise_const",
                                 randn((resolution, resolution), generator))
            self.noise_strength = nn.Parameter(torch.zeros(()))

    def input_scale(self, w, rows=None):
        """The styles this layer's modulated conv scales its input by."""
        return normalize_styles(self.affine(w), rows)

    def forward(self, x, w, gain=1.0, noise_mode="random", noise_seed=None,
                row0=0, rows=None, slab=None, src=None, styles=None,
                addend=None, scales=()):
        """``noise_seed``: an integer, or a noise table (its row
        ``layer_id`` holds the key and the first counter row; ``row0`` is
        then 0); ``row0``: the random noise's first counter row; ``rows``: this
        worker's rows of a global batch, whose style statistic the
        modulated conv reads (None: the batch is whole); ``slab`` / ``src``:
        the output rows this rank computes and what ``x`` holds (spatial
        sharding; None: the whole plane); ``styles``: ``x`` already holds
        ``x ⊙ styles`` (``w`` is then not read); ``addend`` / ``scales``:
        the epilogue's fold."""
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}")
        mode = noise_mode if self.use_noise else "none"
        if mode == "random" and noise_seed is None:
            raise ValueError("noise_mode='random' requires a noise_seed")
        prescaled = styles is not None
        x, dcoefs = modulated_conv2d(x, self.weight,
                                     styles if prescaled else self.affine(w),
                                     up=self.up, padding=self.padding,
                                     resample_filter=self.resample_filter,
                                     flip_weight=(self.up == 1),
                                     split_dcoefs=True, rows=rows,
                                     slab=slab, src=src, prescaled=prescaled)
        key = None
        if mode == "random":
            key = (noise_seed[self.layer_id]
                   if isinstance(noise_seed, torch.Tensor)
                   else noise_key(noise_seed, self.layer_id))
        return noise_bias_act(
            x, dcoefs, self.bias, epilogue_act(self.activation, gain),
            noise_mode=mode, noise_key=key,
            noise_const=self.noise_const if mode == "const" else None,
            strength=self.noise_strength if mode != "none" else None,
            row0=row0, slab=slab, addend=addend, scales=scales)


class ToRGBLayer(nn.Module):
    """Modulated 1×1 conv to RGB without demodulation; styles carry the
    equalized-LR weight gain."""

    def __init__(self, in_channels, out_channels, kernel_size, w_dim,
                 activation=None, generator=None):
        super().__init__()
        self.weight_gain = 1.0 / np.sqrt(in_channels * kernel_size ** 2)
        self.activation = get_activation(activation)
        k = kernel_size
        self.weight = nn.Parameter(
            randn((out_channels, in_channels, k, k), generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.affine = Dense(w_dim, in_channels, bias=True, bias_init=1.0,
                            generator=generator)

    def input_scale(self, w):
        """The styles this layer's modulated conv scales its input by."""
        return self.affine(w) * self.weight_gain

    def forward(self, x, w, slab=None, styles=None):
        """``slab``: ``x`` is this rank's slab of the planes (spatial
        sharding), and so is the result; ``styles``: ``x`` already holds
        ``x ⊙ styles`` (``w`` is then not read)."""
        prescaled = styles is not None
        x = modulated_conv2d(x, self.weight,
                             styles if prescaled else self.input_scale(w),
                             demodulate=False, slab=slab, src=slab,
                             prescaled=prescaled)
        x = add_bias(x, self.bias, slab)
        if self.activation is not None:
            x = self.activation(x)
        return x
